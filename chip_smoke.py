"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each, in order; any failure exits non-zero:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: the CUDA kernels from ``slam_constructor_tpu_torch/csrc`` with
   nvcc for sm_90a, one process a source (seconds, and ptxas'
   register/shared-memory report);
3. ``overlap_score`` against ``overlap_score_ref`` on the card at the
   main-path shapes, at edge cases and at three shapes of the paths (K = 1
   at the obstacle reducer, K = 6 on a 1024^2 map at 0.05 m, the 1,089 poses
   of the brute-force grid): max |diff| <= 2e-6, and the bits of the
   128-thread group's sums (``overlap_score_ordered``); then both timed
   with CUDA events at the main-path shape, and the three shapes replayed
   from a CUDA graph, a call and chained, each beside its bound;
4. ``polar_free_plane`` against ``polar_free_plane_ref`` on the card at the
   main-path shape (256^2 cells, 360 beams) and at edge cases: bit for bit
   (no cell's free decision differs: both compute the reference's
   ``atan2f``/``sinf``/``cosf``/``atanf``, ``csrc/libm.cuh``); then both
   timed;
5. the particle match (the RBPF's 30 particles' matches in one launch of
   ``csrc/mc_match.cu``) on the arguments of every 32nd match of a run of
   the gmapping path (30 maps of 256^2, 160^2 windows read in place, 180
   beams, 5 rounds of 20): ``mc_match_windows`` on them, on the windows
   clamped at each of the map's four edges and corners, on a window as
   large as the map and with the occupancy a channel of the maps' cells,
   against ``mc_match_batched`` on the same windows cut out; ``mc_match_batched`` on the cut-out windows and on edge
   cases (K = 1, 13, 64 and 100, 0 rounds, a particle without a valid beam,
   P = 1, P = 64); each against 30 single-plane ``mc_match`` launches and
   ``mc_match_rounds`` (bit for bit), ``mc_match_batched`` also against its
   plain twin (as ``mc_match`` below); then timed in turns with the
   windows cut out and matched (the path's form before the windows were
   read in place), beside 30 single launches;
6. ``mc_match`` (one launch a match) against ``mc_match_rounds`` (one
   ``overlap_score`` launch a round) on the card: (map, scan, prior) states
   taken from every 32nd scan of a tiny and a viny run over the bench
   sequence and of a run of the loop-closing pipeline over its own (a 192^2
   window of the map with a shifted origin, 180 beams, 12 rounds), plus
   edge cases (batch 8 to 100, 0 and 1 rounds, no valid
   beam, a prior 0.5 m from the map's edge, noise of zeros, duplicated
   candidates, a NaN weight): pose, prob and trace must be equal bit for
   bit. The same cases against the plain twin ``mc_match_ref``: trace and
   prob within 2e-6, or, where the two part, a round before that in which
   the twin's keep-if-better or argmax was decided by less than 4e-6.
   Then all three timed at the shapes of the tiny, the viny and the full
   path;
7. card vs CPU: the first 8 scans of the sequence on the card and on the
   CPU (plain twins) with the same matcher noise, for tinySLAM and vinySLAM;
8. tinySLAM main path (``tiny_config(map_size=256)``) over the bench
   sequence (512 scans, 360 beams, cecum world) through ``Engine.run``,
   warm-up first, then a timed run from a fresh state under
   ``torch.cuda.set_sync_debug_mode("error")``: ``mc_match`` must have been
   launched 512 times and ``overlap_score`` not at all, poses finite, ATE
   below odometry's and below 0.15 m; then once more for repeatability;
9. vinySLAM main path (``viny_config(map_size=256)``), the same way:
   ``mc_match`` and ``polar_free_plane`` launched 512 times each, poses
   finite, ATE below odometry's and no more than 0.02 m above what the JAX
   reference reads on the identical sequence (its worst of five matcher
   keys: the card draws its own matcher noise);
10. the first 64 scans of the viny path with ``mc_match_rounds`` handed in
   in the fused kernel's place (``overlap_score`` launched 64 x 17 times):
   the trajectory must equal the fused path's first 64 poses bit for bit;
11. the loop-closing pipeline, ``FullSlamEngine`` at the width of bench.py's
   ``full`` preset: 512 scans over two laps of the cecum rectangle, 360
   beams, a 256^2 map, tracker ``tiny.fast_config(map_size=256, stride=2,
   mc_rounds=12)`` (``mc_match`` on a 192^2 window), keyframes 0.7 m apart,
   up to 4 loop candidates a keyframe on 120^2 submaps, a closure burst
   every 8 loops, one segment. A warm-up run (made before phase 5) keeps
   the arguments of every 32nd match and of every launch of
   ``overlap_score_batched``; then the timed run, with
   ``torch.cuda.set_sync_debug_mode("error")`` while the segment is tracked:
   ``mc_match`` launched 512 times, ``overlap_score_batched`` twice a
   keyframe batch and twice a densify round (the brute-force grid and the
   information estimate), keyframes > 0 and loops >= 1, the corrected
   trajectory's ATE below odometry's, no more than 0.02 m above the worst
   of the JAX reference's five matcher keys on the same sequence and no
   more than 0.02 m above the same tracker's ATE without the graph; then
   once more: trajectory, graph and map equal bit for bit;
12. ``overlap_score_batched`` on the kept launches (M up to 32 submaps of
   120^2, K = 343 and K = 7, a different scan a map) and on edge cases
   (M = 1, M = 5, a map with no valid beam): against its plain twin
   (max |diff| <= 2e-6) and against M single-plane ``overlap_score``
   launches (bit for bit), the named cases also against the 128-thread
   group's sums (``overlap_score_ordered``, bit for bit); then timed at
   M = 32, K = 343;
13. card vs CPU over a short loop-closing run (a lap and 14 scans more, 360
   beams, keyframe batches and closure bursts included) with the same
   matcher noise: the same graph structure and loop count, poses within
   1e-3;
14. the GMapping RBPF at bench.py's ``gmapping`` preset
   (``gmapping.fast_config(n_particles=30, map_size=256)``) over the bench
   sequence through ``GMappingEngine.run``, under
   ``torch.cuda.set_sync_debug_mode("error")`` (warmed up by the run of
   phase 5): ``mc_match_batched`` launched 512 times (through
   ``mc_match_windows``) and nothing else, no match window cut out, the
   winner's ATE no more than 0.02 m above the worst of the JAX reference's
   five keys (which do not beat odometry on this sequence); then once more:
   trajectory, genealogy, log-weights and maps equal bit for bit;
15. the same over the reference's two-lap quality sequence: the winner's ATE
   below odometry's and no more than 0.02 m above the reference's worst key;
16. 64 scans with the improved proposal and the minimumScore gate on:
   ``overlap_score_batched`` launched twice a scan at M = 30 (the probes,
   K = 16, and the gate, K = 1), every 8th launch of each held to its twin
   (2e-6) and to 30 single-plane launches (bit for bit), then both timed;
17. card vs CPU: the first 16 RBPF scans with the same draws (made with
   numpy): poses within 1e-4, the same ancestors, log-weights within 1e-4,
   the maps equal but for a few cells that counted a border sample;
18. vinySLAM with the M3RSM matcher (``viny_m3rsm_config(map_size=256)``)
   over the bench sequence: a warm-up run that keeps the whole match's
   arguments of every 32nd scan, then the timed run under
   ``torch.cuda.set_sync_debug_mode("error")``: ``m3rsm_search`` 512
   launches (the whole match, one a scan), ``m3rsm_pyramid`` 513 (the build
   in ``init_state`` and a refresh a scan), nothing else; ATE below
   odometry's and no more than 0.02 m above the JAX reference's (one run:
   M3RSM draws no noise); a second run equal bit for bit; the live pyramid
   equal to a rebuild of the final map;
19. card vs CPU: its first 32 scans, poses within 1e-4;
20. the same path with ``m3rsm_search_levels`` handed in in the kernel's
   place (one ``m3rsm_level`` launch a level and one
   ``overlap_score_batched`` launch a hill-climb round: 2,560 and 4,608
   launches): the trajectory equal to the timed run's bit for bit;
21. ``m3rsm_match_many``: 8 requests against the path's final map equal to
   8 single calls bit for bit;
22. ``m3rsm_search`` (K4b, the whole match in one launch) against
   ``m3rsm_search_levels`` bit for bit (pose, prob, trace) on the kept
   arguments of every 32nd viny_m3rsm scan, every 4th loop match of
   phase 25's warm-up run (M up to 32 submaps, K up to 1,024), 8 requests
   on one map, window 0, ``M3RSMConfig``'s defaults (the whole map, 5
   levels, 17 thetas) with the path's scan and with a scan of 1,081 beams,
   refine 0 and an all-unknown map; against its plain
   twin: prob within 2e-6 where the poses are equal, else the twin's
   scores of the two winners within 2e-6, the case named; then timed
   (a call, chained, replayed from a CUDA graph) beside the level launches
   and the twin;
23. ``m3rsm_score_level`` (K4b's level score, now the yardstick's) against
   its plain twin (2e-6) on the level launches of the kept arguments at
   all five levels and at edge cases (the window at the map's first and
   far corner, rects off the window, a mask of zeros), then timed at each
   level of a scan;
24. ``m3rsm_pyramid`` (K4a) against its plain twin bit for bit: the path's
   256^2 map at 4 levels, the occupancy as a channel of the cells, an
   unaligned 100 x 90 map at 5 levels, the loop closer's submap builds (32
   of 120^2 at 3 levels) kept from a warm-up run of phase 25; the 144^2
   refresh into new planes, clamped at every corner and edge, and with the
   gate at 0 (a copy), the planes handed in untouched; then timed (a call,
   chained, replayed from a CUDA graph), beside four chained
   ``max_pool2d`` calls (a call and replayed);
25. the loop-closing pipeline with the M3RSM loop matcher of the
   reference's own test (``full_m3rsm_config``): launches per loop match
   (a keyframe batch or a densify round) one ``m3rsm_pyramid``, one
   ``m3rsm_search`` and one ``overlap_score_batched`` (the information
   estimate, after the match); loops >= 1; the corrected ATE below
   odometry's and no more than 0.02 m above the reference's worst of five
   keys (the reference's graph makes its tracker worse here, so the
   tracker-alone bound is not applied); a second run equal bit for bit.

26. the command-line runner (``slam_constructor_tpu_torch.run``, called in
   this process through ``run.execute``, which is ``main`` less the print)
   on every ``configs/*.properties`` at the config's own widths on the card:
   128 scans of the cecum rectangle (64 for gmapping and tum_2d), 360 beams;
   its scans/s, ATE and RPE; the launches the design gives (tiny, viny and
   mit_stata ``mc_match`` 1 a scan, mit_stata also ``pool_prepare`` and
   ``pool_insert`` 1 a scan and never a plain version of the pool's
   (``POOL_TWINS``: the twins, ``cow.prepare_write``,
   ``blockmap.allocate_tiles``); tiny_refined also ``gradient_refine``
   1 a scan, its gradient refine; mit_csail ``hill_climb`` 1 a scan, its
   hill climb; viny_m3rsm ``m3rsm_search``
   1 and ``m3rsm_pyramid`` 1 a scan + 1; gmapping ``mc_match_batched`` 1;
   tum_2d also ``overlap_score_batched`` 1, its improved proposal); the
   same engine driven directly with the same config and seed, under
   ``torch.cuda.set_sync_debug_mode("error")``, equal to the CLI's
   trajectory bit for bit (for mit_stata: two runs of the tiled map, no
   host sync, and a run with the pool insert's twin handed in, held as in
   phase 36); for tiny_refined, mit_csail and mit_stata the ATE within
   0.02 m of the JAX reference's worst of five keys on the same sequence
   and 8 scans card against CPU (1e-4); mit_stata's pool not exhausted
   (its allocated fraction printed); then tiny and gmapping on the two
   CARMEN fixtures of ``tests/data/``; then tiny_refined and mit_csail once
   more, through the CLI and driven directly, with the refine's yardstick
   (``gradient_refine_rounds``: ``overlap_score_grad`` 13 a scan;
   ``hill_climb_rounds``: ``overlap_score`` 11 a scan) handed in in the
   kernel's place: the same trajectories bit for bit, and both scans/s;
   ``overlap_score`` against its plain twin (2e-6) on that mit_csail run's
   hill climb every 16th scan (its first score, K = 1, and its first round,
   K = 6, on the 1024^2 plane), then timed at the round: the ``kernels``
   line's times and bound for it;
27. ``overlap_score_grad`` (the score and its pose gradient in one launch)
   against its autograd twin on every 97th launch of the tiny_refined run
   with the yardstick (K = 1, 360 beams, 256^2) and on a pose 0.4 m from
   the map's edge, K = 7, and every second beam with beam weights: the
   score the bits of ``overlap_score``, within 2e-6 of the twin's, the
   gradient within 1e-5 x max(1, |g|); then timed (replayed from a CUDA
   graph, a call, chained) beside its bound and the twin;
28. ``gradient_refine`` (tiny_refined's whole refine in one launch) on the
   refines kept from every 16th scan of its CLI run and edge cases (0, 1
   and 24 iterations, a start pose 0.4 m from the map's edge, every second
   beam with beam weights, no valid beam, a NaN weight): pose, prob and
   trace equal bit for bit to ``gradient_refine_rounds``; against its plain
   twin prob and trace within 2e-6 and the pose within 1e-5, or where they
   part a decision closer than 4e-6 before it (printed); then timed at the
   path's shape (replayed from a CUDA graph, a call, chained) beside the
   yardstick and the twin;
29. ``hill_climb`` (mit_csail's whole refine in one launch) the same way,
   and M maps in one launch (the 8 kept climbs stacked,
   and 32 with the start poses moved) equal to M single launches and to
   ``hill_climb_rounds`` on the M maps bit for bit.

30. the reducers other than the bilinear overlap (the obstacle reducer,
   the max and the mean over 3^2 and 5^2 cells, the overlap reducer at
   extents 0.5, 1.6 and 2.5) in the scoring kernels at the shapes of the
   BASELINE gmapping preset (``utils.config.preset('gmapping')``,
   ``GMappingConfig()``: 30 whole maps of 256^2, 360 beams, 6 rounds of 16),
   on the arguments of every 32nd particle match of a warm-up run of that
   path: ``mc_match_batched`` equal to 30 single ``mc_match`` launches and
   ``mc_match_rounds`` bit for bit and within 2e-6 of its twin, at every
   variant with the edge cases (a particle without a valid beam, a NaN
   weight, a pose off the map, windows clamped at the map's edges read in
   place against the same cut out); ``overlap_score_batched`` against its
   twin and 30 single launches, ``hill_climb`` on 30 maps and one against
   ``hill_climb_rounds``, ``m3rsm_search`` at ``M3RSMConfig()`` against
   ``m3rsm_search_levels``; then each variant of the particle match timed
   (replayed from a CUDA graph, a call, chained) beside its twin and its
   bound by the cells its taps read;
31. the gmapping preset's main path through ``preset('gmapping')`` over
   the bench sequence under ``torch.cuda.set_sync_debug_mode("error")``:
   ``mc_match_batched`` 512 launches, all with the obstacle reducer, and
   nothing else; finite poses; the winner's ATE at most 0.02 m above the
   worst of the JAX reference's five keys (``reference_ate.py --preset
   gmapping_baseline``); scans/s; then ``run.py --preset gmapping`` (512
   scans of its own rectangle) with the same launches, equal to the
   preset's engine driven directly bit for bit;
32. card vs CPU: the preset's first 8 scans with the same draws;
33. global relocalization (``ops/relocalize.py``) on the card: the
   reference's test map and its three kidnapped poses, each within 0.12 m
   and 0.08 rad, one ``hill_climb`` launch a call and no host sync, the
   FFT's pose within a cell and a heading bin of the CPU's;
34. K3, the scan insert with its cell fold (``kernels.scan_insert``,
   ``csrc/scan_insert.cu``, one launch a call: a block a band of a
   window's rows). Every main path (tiny, viny, full, gmapping,
   the gmapping preset, viny_m3rsm) and every CLI config but mit_stata runs
   once more with K3's plain twin handed in, the kernel also run on every
   call's arguments: the trajectory equal to the kernel path's bit for
   bit, or, where they part, an insert at or before that scan whose twin
   cells differed from the kernel's. The inserts kept from those runs
   (every 64th; every 32nd of mit_csail and tum_2d) and edge cases (q = 0,
   no valid beam, every beam past a 1 m usable range, a 64^2 map that most
   samples fall off, gmapping windows clamped at corners and edges and at
   each of the four edges, viny's map as 4 windows with the polar fill, a
   beam along the boundary of two rows, the area estimator with the blur at
   360 beams, 1,024 beams into one cell (a run over chunks of 512) and
   3,000 beams with the area estimator, 39,000 occupied samples, above the
   sort's old cap): equal to ``scan_insert_ordered`` (the samples summed on
   the host in sample order) bit for bit, two launches equal, the cells
   outside the windows copied, and equal to the twin but in cells with 32
   occupied samples or more (the card's ``index_put_`` sums those by a
   warp), within 1e-6 relative (a run of n >= 1,000 samples: n 2^-24); then
   timed at each path's shape (graph replay, a call, chained) beside the
   twin and the bound;
35. K3 without the fold, the shared-plane rasteriser (``kernels.
   scan_planes``, the same source): the full and full_m3rsm paths run once
   more with its plain twin handed in (the card's ``index_put_``, the
   rasteriser the paths ran before), the kernel also run on every call's
   arguments: the
   trajectory equal to the kernel path's bit for bit, or, where they part,
   the cells in which the two differed, counted and printed. Every 4th
   call kept from those runs (the loop closer's submap renders and the
   regenerated map's groups), one ``joint_refine`` round of 8 keyframes and
   a plane of 32 keyframes (57,600 occupied samples): equal to
   ``scan_planes_ordered`` bit for bit, two launches equal, and equal to
   the twin but in cells with runs of 32 or more (within n 2^-24
   relative); then timed at a render, a regeneration group and the joint
   refine round beside the twin and the bound.
36. the RBPF on the copy-on-write block pool (``ops/cow.py``) at bench.py's
   ``gmapping`` width (``COW_FIELDS``: 160^2 windows as 5 x 5 tiles of 32,
   1,024 blocks), 512 scans with the sync check on: ``mc_match_batched``,
   ``pool_prepare`` and ``pool_insert`` 512 launches each and nothing else
   (no ``pool_touched``), no plain version of the pool's called (no
   ``cow.prepare_write``), whether the overflow latch was set, the
   distinct blocks at the end, the pool's bytes beside the dense path's 30
   maps, the winner's ATE within 0.02 m of the JAX reference's worst of five
   keys, two runs equal bit for bit; once more with the pool insert's plain
   twin handed in (the kernel run on a copy of every call): the trajectory
   bit for bit, or parting only after an insert whose live blocks differed
   in cells of 32 samples or more (trap c), counted;
37. the same over the reference's two-lap quality sequence (the winner's
   ATE within its worst key + 0.02 m; the same launches a scan, no plain
   version);
38. card vs CPU: the first 16 copy-on-write scans with the same draws
   (on the card the same launches a scan and no plain version; poses and
   weights within 1e-4, ancestors equal, every particle's map
   as the dense RBPF's is held); then a ``handle_scan`` run from 64 blocks
   whose latch is read every 32 scans: the pool grows, card and CPU equal;
39. ``Engine.auto_grow``: tiny and viny_m3rsm (its search on the whole
   map: a grown map's sides are no multiples of 2^levels, which the
   windowed search refuses, in the reference too) from a 96^2 map through
   ``handle_scan``, 64 scans: the map grows, the pyramid is rebuilt on
   growth (one ``m3rsm_pyramid`` launch more a growth), shapes, origins and
   poses (1e-4) equal to the CPU run's;
40. K3 over a block pool (``kernels.pool_insert``, the same source: a fixed
   grid taking a work list's items) and its marking mode
   (``kernels.pool_touched``) on the calls kept from the mit_stata and
   copy-on-write runs and on edge cases (beams along tile boundaries, a
   particle at the table's corner, a scan without a valid beam, shared
   untouched blocks, a pool exhausted by the tiled map): equal to
   ``pool_insert_ordered`` bit for bit on every live slot, two launches
   equal, dead slots untouched, the twin equal but in cells of 32 samples
   or more; the marks equal to their twin; then both timed at each path's
   shape (graph replay, a call, chained; the insert from its work list)
   beside the twin and the bound (bytes: the live blocks read and written
   once, and the scans). Then the prepare launch (``kernels.pool_prepare``:
   the marks, the copy-on-write compaction and block copies or the tiled
   allocation, the owners and the work list, one cluster) on the prepare
   calls kept from both runs and on edge cases (a tile corner, the table's
   corner, a NaN pose, no valid beam, free limits on samples, a budget of
   7 new blocks, every touched tile shared, the first step, an empty pool of
   64 blocks under trap o, q = 0, an exhausted tiled pool, a pool of
   16,384 blocks too large for block 0's shared memory): equal to its
   plain version (``cow.prepare_insert_ref`` or
   ``blockmap.prepare_tiles_ref``) bit for bit in marks, tables,
   refcounts, latch or n_alloc, the whole pool, owners and work list, and
   the insert from its list equal to ``pool_insert_ordered``; then timed
   on each path's kept call and on the state resampled to one ancestor
   (its new blocks copies; the state restored in the graph, the restore
   timed alone and taken off) beside the plain version and the bound
   (bytes: the tables, refcounts, marks, owners and list, each new block's
   source read and the block written).
41. every matcher in every RBPF slot at bench.py's gmapping width (30
   particles, 160^2 windows of 256^2 maps, every second beam, 512 scans,
   sync check on): the hill climb, M3RSM and the gradient ascent (the
   general overlap, extent 2 on 5^2 cells) as the primary match, and each
   as the refine after the Monte-Carlo match, on the dense maps; the
   Monte-Carlo match with the hill-climbing refine and the gradient ascent
   on the copy-on-write pool: launches (one ``hill_climb``,
   ``gradient_refine``, or ``m3rsm_pyramid`` and ``m3rsm_search`` a scan
   over the 30 windows), finite poses and maps, the winner's ATE (the
   hill-climbing refine within the reference's worst key + 0.02 m, two runs
   equal bit for bit);
42. card vs CPU: the first 8 scans of each of those runs with the same
   draws (made with numpy): poses and log-weights within 1e-4, ancestors
   equal;
43. the loop-closing pipeline with the hill-climbing and with the gradient
   loop matcher (``full_loop_config``; the gradient on the overlap of
   extent 1.5): as phase 11, one ``hill_climb`` or ``gradient_refine`` over
   the submaps a loop match, the corrected ATE within the reference's
   worst key + 0.02 m and below odometry's;
44. ``posegraph.joint_refine`` with the hill climb, the gradient ascent and
   M3RSM (the reference's default configs) over 8 keyframes of the full
   sequence, 2 rounds: a ``scan_planes`` and the matcher's launches over
   the 8 leave-one-out maps a round; card vs CPU within 1e-4;
45. the CLI's tiny_refined with its gradient refine at the obstacle reducer
   (piecewise constant: one ``overlap_score`` a scan and the trajectory of
   the engine without the refine, bit for bit) and at the overlap of extent
   1.5 (one ``gradient_refine`` a scan); card vs CPU on 8 scans each;
46. checkpoints on the card: the RBPF with the hill-climbing refine (dense
   and copy-on-write) and viny_m3rsm stopped after 32 scans, saved
   (``utils.checkpoint``; the state holds its key), restored into a
   fresh engine and run 32 more; the full pipeline with the hill-climbing
   loop matcher saved after its first lap (``save_checkpoint``), restored
   and finished: each equal to the unbroken run bit for bit;
47. the kernels of those paths on calls kept from them (every 64th launch,
   every loop-closer launch): ``gradient_refine`` (one map at extent 1.5,
   30 windows at extent 2, the submaps at extent 1.5, the joint refine's 8
   maps) and ``hill_climb`` (30 windows, the submaps) bit for bit their
   yardsticks and single-map launches and within 2e-6 of their twins;
   ``overlap_score_grad`` at those reducers, one map and 30 (the score the
   bits of ``overlap_score(_batched)``, the gradient within 1e-5 x max(1,
   |g|) of its twin away from the reducer's kinks); ``m3rsm_search`` (30
   requests) and ``m3rsm_pyramid`` (30 windows) over the RBPF's windows;
   each timed beside its twin with its bound, and listed in the kernels
   line with its launches on its path.

48. the multi-device layer (``parallel/``) in an NCCL group of world size 1
   set up in this process (127.0.0.1, a free port: one H100 cannot host two
   NCCL ranks), each path against the unsharded port on the card over the
   first 64 bench scans: the ``distributed`` preset at its full width
   (``GMappingConfig()``: 30 whole 256^2 maps, 16 x 6 rounds; both sides
   from ``PRNGKey(0)``, drawn alike on every rank: ancestors equal, poses and log-weights
   within 1e-6, the same launches); the ``ep_cow`` step and the ``ep2d``
   1 x 1 step at the copy-on-write cell's config (numpy draws; ancestors
   equal, poses, weights and every particle's map within 1e-6, the same
   launches, no overflow); the row-sharded block map (8 x 8 tiles of 32):
   64 inserts and scores of 64 candidates (``pool_prepare``,
   ``pool_insert`` and ``overlap_score_partial`` once each a scan), the
   scores within 2e-6 x max(1, |s|) of the unsharded tiled map's, its
   tables and allocation equal; the halo and beam-sharded scores at every
   reducer; ``distributed_optimize`` on the full path's graph (1e-5 of
   ``posegraph.optimize``; the Schur elimination 1e-4 of it); a heartbeat
   and a ``RecoveryLoop`` round trip equal bit for bit. The group is torn
   down before the next phase;
49. ``overlap_score_partial`` (a rank's share of a row-sharded score, the
   new mode of K1's kernel) against its plain twin on every band of 2, 4
   and 8 row partitions at every reducer (2e-6: its sums relative to their
   size, the band's mean num / den absolute) and the bands' sums
   against ``overlap_score`` (2e-6 x max(1, |s|)), one band of the whole
   plane against ``overlap_score`` bit for bit; then timed (replayed from
   a CUDA graph, a call, chained) beside its twin and its bound;
50. (run after phase 4) ``prng_draws`` (``csrc/threefry.cu``: a step's
   random numbers from the reference's threefry key in one launch) against
   the committed draws of JAX (``tests/data/prng_reference.npz``: edge
   seeds, splits, bits / uniform / normal at the paths' shapes, the
   engine's and the RBPF's split trees, the synthetic sequence's, and the
   SHA-256 of the normal transform over its 2^23 inputs) and against its
   plain version (``ops/prng.py``) on the card on every path's step plan
   at edge keys, bit for bit; then timed at the tiny, RBPF and synthetic
   plans beside its bound (hashes' int32 operations over the int32 rate).
   Every RBPF step and every engine step whose matcher is not a Monte-Carlo
   match alone launches it once (the launch counts above include it; the
   CLI's synthetic sequence adds one); the tiny, viny and full trackers'
   matches draw inside ``mc_match`` (phase 53);
51. (run after phase 14) tiny, viny, full and gmapping from the
   reference's keys 0..4: the port's ATE beside the reference's from the
   same key on the same sequence, and their paired difference.
   ``python3 chip_smoke.py --phase prng`` runs phases 1, 2 and 50 alone
   and prints no result;
52. (run after phase 50) ``csrc/libm.cu``, the reference's math library:
   each function's kernel over all 2^32 float32 inputs (``atan2`` over
   2^26 seeded pairs and a grid) hashed against the committed digests of
   the jitted reference (``tests/data/libm_digests.json``), the kernels
   against their plain versions (``ops/libm.py``) on the card bit for bit,
   the fused sites too (pose operations, log-sum-exp rows,
   fused multiply-add); then timed beside ``torch.sin`` and the bound.
   Its launches are counted apart, by function (``kernels.
   libm_launch_counts``), and held on each main path to its sites a scan
   (``LIBM_A_SCAN``: tiny, viny, viny_m3rsm, the rounds and levels paths,
   the full paths' tracking, the RBPF, its preset, improved proposal and
   copy-on-write maps); the full paths' keyframe work is printed.
   ``python3 chip_smoke.py --phase libm`` runs phases 1, 2 and 52 alone;
53. (run after phase 14) ``mc_match`` drawing its own numbers from the
   engine step's key in its prologue (``kernels.KeyNoise``) against the
   same match handed those draws (``kernels.ErfInvDraws``), bit for bit,
   and the next key against ``split(key)[0]``, on the recorded states of
   tiny, viny and full and at edge keys, rounds and batches; its device
   time beside the handed-in route's;
54. (run after phase 53) ``mc_match_scan``: the single match from the scan
   and the odometry (the prior ``compose(pose, odom)`` and the kept beams'
   endpoints and weights in the match's prologue, the bits of
   ``csrc/libm.cu``'s ``libm_pose`` and ``libm_cossin``) against
   ``mc_match`` handed the prior and the points, bit for bit, on recorded
   calls of the tiny and viny paths (their own draws, standard normals, no
   odometry); both routes' device time. ``beam_weights``
   (``csrc/beam_weights.cu``: viny's weights, the endpoint angles, the
   histogram's integer bins and the weights in one launch) against its plain
   version (``scan.point_weights_ref``) on the card and the CPU on all 512
   bench scans, bit for bit; timed at the viny path's shape beside its bound.
   K5 drawing each particle's numbers from its match key against K5 handed
   those draws, in place and cut out, bit for bit, on the gmapping path's
   recorded matches. The score sites: every beam's probability on the card
   (one-beam ``overlap_score`` launches) against the CPU twin's (the
   reference's jitted endpoint arithmetic, ``grid.endpoint_cells``) bit for
   bit, at four reducers; the whole scores within 2e-6.

Every bound counts, of the plane or window, the distinct cells that the
taps of every pose the kernel scores read (the poses taken from its
yardstick's run on the same inputs), not the whole plane.

Every path on a dense map inserts through ``scan_insert`` once a scan, the
tiled mit_stata and the copy-on-write RBPF through ``pool_prepare`` and
``pool_insert``; the full paths' submaps and
regenerated maps rasterise through ``scan_planes``. The launch counts are set to
0 just before each of these runs and read just after it. The line before the last is a JSON object of the
kernels; the last line is ``{"ok": true, "device": {...}}``. It needs no
network and starts no process that outlives it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 2e-6  # the bound the reference holds its Pallas path to
N_SCANS, N_BEAMS, MAP = 512, 360, 256

#: ATE of the JAX reference on a CPU over this very sequence with the free
#: fill pinned to 'polar', once for each matcher key PRNGKey(0..4)
#: (`JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --preset
#: viny --keys 5 --port`). A single run's ATE is bimodal in the matcher's
#: noise alone and parts on a knife edge between lowerings (ROADMAP trap
#: i), so the card's run (key 0's draws, the reference's own) is held to
#: the reference's worst key plus the margin, not to key 0. With a key's
#: noise injected the port on the CPU reads that key's figure.
VINY_REFERENCE_ATE_BY_KEY = (0.07265, 0.07982, 0.07299, 0.11143, 0.11816)
VINY_ATE_MARGIN = 0.02
#: the same for tiny (its DDA fill): `reference_ate.py --preset tiny --keys
#: 5`; the port on the CPU from each key reads 0.07362, 0.07395, 0.07399,
#: 0.0739, 0.07368 m
TINY_REFERENCE_ATE_BY_KEY = (0.07362, 0.07389, 0.07399, 0.07374, 0.07388)

#: corrected-trajectory ATE of the JAX reference's ``FullSlamEngine`` on a
#: CPU over the full path's sequence and configuration, once for each
#: matcher key PRNGKey(0..4) (`JAX_PLATFORMS=cpu python
#: scripts/torch_port/reference_ate.py --preset full --keys 5`)
FULL_REFERENCE_ATE_BY_KEY = (0.07739, 0.07623, 0.08515, 0.08183, 0.07648)
FULL_ATE_MARGIN = 0.02

#: winner ATE of the JAX reference's RBPF on a CPU over the tiny sequence
#: at bench.py's gmapping preset (30 particles, 160^2 windows), once for
#: each key PRNGKey(0..4) (`JAX_PLATFORMS=cpu python
#: scripts/torch_port/reference_ate.py --preset gmapping --keys 5 --port`)
#: The reference's RBPF does not beat odometry on this sequence (0.4532 m):
#: 0.7 of a lap in 0.0375 m steps, no loop. On the reference's own quality
#: sequence (`gmapping_quality_sequence`, `--preset gmapping_2lap`) it does,
#: and the card is held to that too.
GMAPPING_REFERENCE_ATE_BY_KEY = (0.52053, 0.49879, 0.45874, 0.64013, 0.60896)
GMAPPING_2LAP_REFERENCE_ATE_BY_KEY = (0.09649, 0.11871, 0.11003, 0.10554, 0.11708)
GMAPPING_ATE_MARGIN = 0.02
#: winner ATE of the JAX reference's ``GMappingEngine()`` at its defaults
#: (``utils.config.preset('gmapping')``, BASELINE config[2]: 30 whole maps
#: of 256^2, the obstacle reducer, 16 x 6 rounds) on a CPU over the bench
#: sequence, once for each key PRNGKey(0..4) (`JAX_PLATFORMS=cpu python
#: scripts/torch_port/reference_ate.py --preset gmapping_baseline --keys
#: 5`); odometry reads 0.45320 m.
GMAPPING_BASELINE_REFERENCE_ATE_BY_KEY = (0.43269, 0.62582, 0.13305, 0.36565, 0.13569)
#: the copy-on-write RBPF (``cow_config``: bench.py's gmapping preset with
#: COW_FIELDS): the JAX reference's winner ATE on a CPU over the bench
#: sequence and over the two-lap quality sequence, once for each key
#: PRNGKey(0..4) (`JAX_PLATFORMS=cpu python scripts/torch_port/
#: reference_ate.py --preset gmapping_cow[_2lap] --keys 5`; no key set the
#: overflow latch, 162-181 and 260-298 distinct blocks at the end)
GMAPPING_COW_REFERENCE_ATE_BY_KEY = (0.59528, 0.53437, 0.52339, 0.63664, 0.54265)
GMAPPING_COW_2LAP_REFERENCE_ATE_BY_KEY = (0.13891, 0.23756, 0.19128, 0.10303, 0.23584)
#: the copy-on-write storage: 160^2 windows (5 tiles of 32, the dense
#: path's), the reference's default pool of 1,024 blocks
COW_FIELDS = dict(map_storage="cow", tile_block=32, window_tiles=5, tile_capacity=1024)
#: every how many pool inserts a path's run with the twin handed in keeps
POOL_EVERY = 64
#: the copy-on-write handle_scan run that grows its pool from 64 blocks
COW_GROW_SCANS = 40
#: the auto-grow runs: scans through handle_scan from a GROW_MAP^2 map
GROW_SCANS, GROW_MAP = 64, 96
#: the reducer variants the kernels are held and timed with: (kind, radius,
#: extent); the obstacle reducer is the gmapping preset's
REDUCER_VARIANTS = (("obstacle", 0, 1.0), ("max", 1, 1.0), ("max", 2, 1.0), ("mean", 1, 1.0),
                    ("mean", 2, 1.0), ("overlap", 0, 0.5), ("overlap", 1, 1.6),
                    ("overlap", 2, 2.5))
#: where the reference computes each reducer (its gather path)
REDUCER_LINES = {"obstacle": 352, "max": 354, "mean": 356, "overlap": 358}
#: the kidnapped poses of the reference's relocalization test
RELOCALIZE_KIDNAPPED = ((3.0, -1.5, 2.1), (-5.0, 1.6, -0.7), (0.0, -1.5, 0.0))

#: ATE of the JAX reference's ``viny_m3rsm_config(map_size=256)`` on a CPU
#: over the bench sequence (`JAX_PLATFORMS=cpu python scripts/torch_port/
#: reference_ate.py --preset viny_m3rsm --port`). M3RSM draws no noise, so
#: one run is the figure; the port on the CPU reads 0.12788 m.
VINY_M3RSM_REFERENCE_ATE = 0.12715
#: corrected-trajectory ATE of the reference's ``FullSlamEngine`` with the
#: M3RSM loop matcher (``full_m3rsm_config``) on a CPU over the full path's
#: sequence, once for each tracker key PRNGKey(0..4) (`JAX_PLATFORMS=cpu
#: python scripts/torch_port/reference_ate.py --preset full_m3rsm --keys 5
#: --port`). Its graph makes the tracker worse here (its tracker alone
#: reads 0.0719-0.0723 m), so the port is not held to its tracker on this
#: path; with key 0's noise the port on the CPU reads 0.13820 m, on the
#: same 247 edges.
FULL_M3RSM_REFERENCE_ATE_BY_KEY = (0.13820, 0.12036, 0.14911, 0.12296, 0.12987)
#: ATE of the JAX reference's engine built from each new CLI config (a
#: refine stage or the tiled map) on a CPU over the CLI phase's synthetic
#: sequence (128 scans of the cecum rectangle, 360 beams, its noise drawn
#: from PRNGKey(0) by both CLIs), once for each matcher key PRNGKey(0..4)
#: (`JAX_PLATFORMS=cpu python scripts/torch_port/reference_ate.py --config
#: configs/<name>.properties --keys 5 --port`). With key 0's noise the port
#: on the CPU reads 0.0706, 0.03689 and 0.03727 m.
CLI_REFERENCE_ATE_BY_KEY = {
    "tiny_refined": (0.07087, 0.07075, 0.07053, 0.07031, 0.07084),
    "mit_csail": (0.0366, 0.03637, 0.0368, 0.0366, 0.03656),
    "mit_stata": (0.03737, 0.03636, 0.03711, 0.03621, 0.03721),
}
CLI_ATE_MARGIN = 0.02
#: the CLI phase: scans of the single-hypothesis configs and of the RBPF's
CLI_SCANS, CLI_RBPF_SCANS = 128, 64
#: the configs whose engines earlier slices hold: the CLI's trajectory must
#: equal the same engine's driven directly, bit for bit
CLI_EARLIER = ("tiny", "viny", "viny_m3rsm", "gmapping", "tum_2d")
#: the new paths: a refine stage (gradient, hill climbing) or the tiled map
CLI_NEW = ("tiny_refined", "mit_csail", "mit_stata")
#: the pose gradient's bound against its twin: relative to max(1, |g|)
GRAD_TOL = 1e-5
#: beams closer than this (cells) to a cell's centre or edge, where the
#: score's derivative jumps, weigh 0 when gradients are compared
KINK_MARGIN = 1e-4
GM_PARTICLES = 30
#: cells of the 30 maps whose count may differ between card and CPU after
#: 16 scans (a DDA sample on a cell's border)
GM_MOVED_CELLS = 32
#: the improved-proposal run: its length and its minimumScore gate
GM_IMPROVED_SCANS, GM_IMPROVED_GATE = 64, 0.7

#: the card's published peaks (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

#: K3's work, in f32 operations (one a +, -, *, /, floor, min, max or
#: compare; cosf and sinf 20 each, expf and logf 15, powf 25): a beam's
#: direction 1 + 2 x 20; a DDA sample before the free limit 16 (t 2, point
#: 4, cell 2 sub + 2 div + 2 floor, the duplicate and map tests 4); an
#: occupied sample 12 (point 4, cell 6, tests 2), and with the area
#: estimator 14 more a neighbour (its square's overlap); a folded cell by
#: the cell model (BayesAvg 8, BayesBase 30 with powf, TBM 130 with three
#: expf and three logf)
K3_BEAM_OPS, K3_FREE_OPS, K3_OCC_OPS, K3_AREA_OPS = 41, 16, 12, 14
K3_FOLD_OPS = {"BayesAvgCell": 8, "BayesBaseCell": 30, "TBMCell": 130}
#: every how many inserts a path's run with K3's twin handed in keeps a
#: call's arguments for phase 34
INSERT_EVERY = 64
#: every how many calls of `scan_planes` kept from the full paths phase 35 holds
PLANES_EVERY = 4
#: a run of this many samples in one cell or more is summed by the twin's
#: warp in another order, n terms apart by up to ~n 2^-24 relative
LONG_RUN = 1000

#: f32 operations a cell of `polar_free_plane`, with the math library's
#: routines counted at the length of their usual path in the built kernel's
#: SASS (scripts/torch_port/kernel_probe.py prints the instruction mix; the
#: whole kernel, slow paths and prologue included, holds 338):
#: cell centre and offsets 8, d 4 + sqrtf 8, atan2f 2 x 40, sinf + cosf
#: 2 x 20, atanf 25, three divisions 3 x 8, rint/compare/select 11
POLAR_OPS_PER_CELL = 8 + 12 + 80 + 40 + 25 + 24 + 11
#: a cell that no beam can reach stops after its centre, d and the test
POLAR_OPS_PER_FAR_CELL = 8 + 12 + 3
#: f32 operations a (candidate, beam) pair of `overlap_score`: pose
#: transform 8, to cell units 4, two axes of taps 2 x 12, blend 14, sum 3
OVERLAP_OPS_PER_POINT = 8 + 4 + 24 + 14 + 3
#: and of `overlap_score_grad`, beyond the score's: the axis weights'
#: derivatives 4, the two derivative blends 2 x 14, the chain to the pose
#: (two divisions, the heading's 11), three more weighted sums 6
GRAD_OPS_PER_POINT = OVERLAP_OPS_PER_POINT + 4 + 28 + 13 + 6


#: what separates `mc_match` from its plain twin: a score differs by the
#: order of its sums (TOL); two scores that decide a keep-if-better or an
#: argmax may therefore fall the other way when they lie within 2 x TOL
KNIFE_EDGE = 4e-6
ROUNDS_PATH_SCANS = 64
#: which of the full path's kept states is timed: scan 288, on the second lap
FULL_TIMED_STATE = 9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: the larger of bytes over its
    memory rate and operations over its f32 rate; and which one binds."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bench_sequence(device):
    """bench.py's tiny geometry: 512 scans along the cecum rectangle, 360
    beams, odometry noise 0.01 m / 0.005 rad from a seeded numpy rng."""
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=device)
    poses = datagen.rectangle_trajectory(step=9.6 / N_SCANS * 2, device=device)
    reps = (N_SCANS + poses.shape[0] - 1) // poses.shape[0]
    poses = poses.repeat(reps, 1)[:N_SCANS]
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS, device=device),
        rng=np.random.default_rng(0), odom_noise_xy=0.01, odom_noise_theta=0.005,
    )


def full_sequence(device, n_scans=N_SCANS, step=2 * 27.2 / N_SCANS, noise=(0.01, 0.005)):
    """bench.py's ``full`` geometry: ``n_scans`` scans over laps of the
    cecum rectangle (two laps of 27.2 m at the defaults, so that the graph
    closes loops), 360 beams, odometry noise from a seeded numpy rng."""
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=device)
    lap = datagen.rectangle_trajectory(step=step, device=device)
    reps = (n_scans + lap.shape[0] - 1) // lap.shape[0]
    poses = lap.repeat(reps, 1)[:n_scans]
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS, device=device),
        rng=np.random.default_rng(0), odom_noise_xy=noise[0], odom_noise_theta=noise[1],
    )


def gmapping_quality_sequence(device, seed=42):
    """The JAX reference's RBPF quality protocol (``scripts/r3/
    gm_multiseed.py``): two laps of the cecum rectangle at 0.3 m a step (182
    scans), 360 beams, odometry noise 0.02 m / 0.012 rad, from a seeded
    numpy rng (the protocol's first seed)."""
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world(device=device)
    poses = datagen.rectangle_trajectory(step=0.3, device=device).repeat(2, 1)
    return datagen.synth_sequence(
        occ, origin, scale, poses, datagen.default_bearings(N_BEAMS, device=device),
        rng=np.random.default_rng(seed), odom_noise_xy=0.02, odom_noise_theta=0.012,
    )


def full_config(**kwargs):
    """bench.py's ``full`` preset."""
    from slam_constructor_tpu_torch.models import full, posegraph, tiny

    return full.FullConfig(
        tracking=tiny.fast_config(map_size=MAP, stride=2, mc_rounds=12),
        graph=posegraph.PoseGraphConfig(
            keyframe_distance=0.7, min_index_gap=8, max_candidates=4, local_map_size=120),
        **{"optimize_every_loops": 8, **kwargs},
    )


#: the M3RSM loop matcher of the reference's own test (tests/test_posegraph.py:451-455)
M3RSM_LOOP_MATCHER = dict(levels=3, half_x=0.6, half_y=0.6, half_theta=0.3, n_theta=7)


def full_m3rsm_config(**kwargs):
    """bench.py's ``full`` preset with the M3RSM loop matcher (overlap
    scoring on every second beam) in the brute-force grid's place."""
    from slam_constructor_tpu_torch.ops import m3rsm, scoring

    cfg = full_config(**kwargs)
    return dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, loop_matcher_kind="m3rsm", loop_matcher=m3rsm.M3RSMConfig(
            **M3RSM_LOOP_MATCHER, scoring=scoring.ScoringConfig(reducer="overlap", stride=2))))


#: the matcher slots of slice 6d: the RBPF's hill climb, gradient ascent and
#: M3RSM (primary or after the Monte-Carlo match), the loop closer's hill
#: climb and gradient ascent. Each is the matcher's config with these fields
#: (``slot_matcher_cfg``); reference_ate.py builds the reference's from them
SLOT_FIELDS = {
    "gmapping": {"hill_climbing": dict(step_xy=0.05, step_theta=0.025, iterations=6),
                 "gradient": dict(iterations=8, step_xy=0.04, step_theta=0.02),
                 "m3rsm": dict(levels=3, half_x=0.3, half_y=0.3, half_theta=0.1, n_theta=9,
                               beam_width=32, refine_iterations=4)},
    "loop": {"hill_climbing": dict(step_xy=0.1, step_theta=0.05, iterations=10),
             "gradient": dict(iterations=12, step_xy=0.06, step_theta=0.03)},
}
#: the gradient slots score with the general overlap (its own kernel path):
#: the RBPF's at extent 2 on 5^2 cells, the loop closer's at extent 1.5 on 3^2
GRADIENT_SCORING = {"gmapping": dict(reducer="overlap", window=2, overlap_extent=2.0, stride=2),
                    "loop": dict(reducer="overlap", window=1, overlap_extent=1.5, stride=2)}
#: the RBPF's slots run on the card: (primary matcher, refine matcher)
GM_SLOTS = (("hill_climbing", None), ("m3rsm", None), ("gradient", None),
            ("monte_carlo", "hill_climbing"), ("monte_carlo", "gradient"),
            ("monte_carlo", "m3rsm"))


def slot_matcher_cfg(where, kind, scoring_cfg, modules=None):
    """The config of matcher ``kind`` in a slot of ``where`` ("gmapping" or
    "loop"): ``SLOT_FIELDS``, the path's scoring (``scoring_cfg``; the
    gradient's general overlap instead). ``modules`` are (matchers,
    scoring, m3rsm): the port's by default."""
    if modules is None:
        from slam_constructor_tpu_torch.ops import m3rsm, matchers, scoring
        modules = (matchers, scoring, m3rsm)
    matchers, scoring, m3rsm = modules
    if kind == "gradient":
        scoring_cfg = scoring.ScoringConfig(**GRADIENT_SCORING[where])
    cls = m3rsm.M3RSMConfig if kind == "m3rsm" else matchers.MATCHERS[kind][0]
    return cls(**SLOT_FIELDS[where][kind], scoring=scoring_cfg)


def gmapping_slot_config(matcher, refine=None, base=None, modules=None):
    """bench.py's gmapping preset (or ``base``) with ``matcher`` as the
    primary match and ``refine`` as the refine; a Monte-Carlo primary keeps
    the preset's."""
    base = base or gmapping_config()
    sc = base.matcher_cfg.scoring
    if matcher != "monte_carlo":
        base = dataclasses.replace(base, matcher=matcher,
                                   matcher_cfg=slot_matcher_cfg("gmapping", matcher, sc, modules))
    if refine is not None:
        base = dataclasses.replace(base, refine_matcher=refine,
                                   refine_cfg=slot_matcher_cfg("gmapping", refine, sc, modules))
    return base


def full_loop_config(kind, base=None, modules=None):
    """bench.py's ``full`` preset (or ``base``) with the loop matcher
    ``kind``."""
    base = base or full_config()
    g = base.graph
    return dataclasses.replace(base, graph=dataclasses.replace(
        g, loop_matcher_kind=kind,
        loop_matcher=slot_matcher_cfg("loop", kind, g.loop_matcher.scoring, modules)))


def odometry_trajectory(start, odom):
    from slam_constructor_tpu_torch.ops.geometry import compose

    p, out = start, []
    for d in odom:
        p = compose(p, d)
        out.append(p)
    return torch.stack(out)


def time_ms(fn, calls: int = 50) -> list[float]:
    times = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_pair(kernel, plain, plain_calls: int = 50):
    """Median ms a call of both, in turns (plain, kernel, kernel, plain),
    each call between its own pair of CUDA events (50 calls a turn of the
    kernel, ``plain_calls`` of the plain version); and the kernel's ms a
    launch with 200 launches queued back to back between one pair."""
    for _ in range(20):  # warm-up
        kernel()
    for _ in range(min(20, plain_calls)):
        plain()
    torch.cuda.synchronize()
    k_ms, p_ms = [], []
    for bucket, fn, calls in ((p_ms, plain, plain_calls), (k_ms, kernel, 50), (k_ms, kernel, 50),
                              (p_ms, plain, plain_calls)):
        bucket += time_ms(fn, calls)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(200):
        kernel()
    b.record()
    b.synchronize()
    return statistics.median(k_ms), statistics.median(p_ms), a.elapsed_time(b) / 200


def phase_overlap_kernel(dev, scans, gt):
    """`overlap_score` vs its plain twin at the main paths' shapes and at
    edge cases; returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.models import tiny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import kernels, raycast, scoring
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    cfg = tiny.tiny_config(map_size=MAP)
    gm = init_state(cfg, dev).gm
    for i in range(0, 40, 2):  # a 256^2 map after 20 bench scans
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
    view = scoring.MapView.of(gm, cfg.cell_model)
    g = torch.Generator(device=dev).manual_seed(1)
    scan, pose = scans[40], gt[40]
    sig = torch.tensor([0.08, 0.08, 0.05], device=dev)
    cand = pose + torch.randn((64, 3), generator=g, device=dev) * sig
    half_off = pose + torch.randn((64, 3), generator=g, device=dev) * torch.tensor(
        [6.0, 6.0, 3.0], device=dev) + torch.tensor([9.0, 0.0, 0.0], device=dev)
    weights = torch.rand((N_BEAMS,), generator=g, device=dev)
    holes = LaserScan(scan.ranges, scan.bearings,
                      scan.valid & (torch.arange(N_BEAMS, device=dev) % 7 != 2))
    r100 = LaserScan(scan.ranges[:100], scan.bearings[:100], scan.valid[:100])
    sc = cfg.matcher_cfg.scoring
    sc2 = scoring.ScoringConfig(reducer="overlap", window=1, stride=2)
    cases = [
        ("main K=64 R=360", scan, cand, sc, None),
        ("main K=1 R=360", scan, cand[:1], sc, None),
        ("R=100 (not a warp multiple)", r100, cand, sc, None),
        ("candidates half off the map", scan, half_off, sc, None),
        ("viny: stride 2, beam weights", scan, cand, sc2, weights),
        ("random beam weights", scan, cand, sc, weights),
        ("invalid beams", holes, cand, sc, weights),
    ]
    max_err = 0.0
    runs = []
    for name, s, poses, c, w in cases:
        prep = scoring.prepare(view, s, c, w)
        runs.append((name, _score_args(
            (prep.plane, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown), poses)))
    runs += list(path_score_shapes(dev, scans, gt, view, cand).items())
    for name, args in runs:
        got = kernels.overlap_score(*args)
        want = kernels.overlap_score_ref(*args)
        ordered = kernels.overlap_score_ordered(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"kernel output not finite ({name})")
        print(f"overlap_score vs plain [{name}]: K={args[1].shape[0]} R={args[2].shape[0]} "
              f"max|diff|={err:.3e} (tol {TOL:g}); the group's sums bit for bit", flush=True)
        check(err <= TOL, f"kernel disagrees with plain twin ({name}): {err}")
        check(torch.equal(bits(got), bits(ordered)),
              f"overlap_score is not the group's sums (overlap_score_ordered) ({name})")
        max_err = max(max_err, err)
    by_shape = {name: overlap_times(args) for name, args in runs[len(cases):]}

    prep = scoring.prepare(view, scan, sc)
    args = (prep.plane, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score(*args),
                                      lambda: kernels.overlap_score_ref(*args))
    # the tap cells and each other input read once, the output written
    # once; operations for the beams that carry weight (the others are
    # skipped)
    n_bytes, cells, sectors = score_bytes(*args[:6], per_pose_out=1)
    n_ops = OVERLAP_OPS_PER_POINT * cand.shape[0] * int((prep.beam_w != 0).sum())
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score K=64 R=360 256^2: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 100 calls each, CUDA events), kernel {chained:.4f} ms a launch over 200 "
          f"back to back; bound {b_ms:.7f} ms by {by} ({n_bytes} B: {cells} tap cells in "
          f"{sectors} 32-B sectors; {n_ops} operations); no single PyTorch call computes it",
          flush=True)
    return {
        "name": "overlap_score", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None, "by_shape": by_shape,
    }


def _score_args(prepared, poses, reducer=None):
    """``overlap_score``'s arguments from (plane, pts, beam_w, origin,
    scale, unknown) and the poses, with ``reducer`` last where given."""
    plane, pts, beam_w, origin, scale, unknown = prepared
    args = (plane, poses.contiguous(), pts, beam_w, origin, scale, unknown)
    return args if reducer is None else (*args, reducer)


def path_score_shapes(dev, scans, gt, view, cand):
    """``overlap_score``'s arguments at three shapes of the paths: K = 1 at
    the obstacle reducer (tiny_refined's flat refine at that reducer), K = 6
    on a 1024^2 map at 0.05 m after the same 20 bench scans (mit_csail's
    hill-climb round), the 1,089 poses of the brute-force matcher's 11 x 11
    x 9 grid (``matchers.brute_force_match``)."""
    from slam_constructor_tpu_torch.models import tiny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import kernels, matchers, raycast, scoring

    scan, pose = scans[40], gt[40]
    sc = tiny.tiny_config(map_size=MAP).matcher_cfg.scoring
    prep = scoring.prepare(view, scan, sc)
    base = (prep.plane, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown)
    cfg = tiny.tiny_config(map_size=1024, map_scale=0.05)
    gm = init_state(cfg, dev).gm
    for i in range(0, 40, 2):
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
    big = scoring.prepare(scoring.MapView.of(gm, cfg.cell_model), scan, sc)
    grid = pose + matchers.brute_force_offsets(matchers.BruteForceConfig(), dev)
    return {
        "K=1 R=360 256^2 obstacle": _score_args(base, cand[:1], kernels.Reducer("obstacle")),
        "K=6 R=360 1024^2 at 0.05 m": _score_args(
            (big.plane, big.pts, big.beam_w, big.origin, big.scale, big.unknown), cand[:6]),
        "K=1089 R=360 256^2 brute-force grid": _score_args(base, grid),
    }


def overlap_times(args):
    """``overlap_score`` on ``args``: device time (replayed from a CUDA
    graph), a call and chained beside its twin's call, and its bound."""
    from slam_constructor_tpu_torch.ops import kernels

    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score(*args),
                                      lambda: kernels.overlap_score_ref(*args), plain_calls=20)
    device_ms = graph_ms(lambda: kernels.overlap_score(*args))
    red = args[7] if len(args) > 7 else kernels.BILINEAR
    n_w = int((args[3] != 0).sum())
    if red.kind == "bilinear":
        n_bytes = score_bytes(*args[:6], per_pose_out=1)[0]
        n_ops = OVERLAP_OPS_PER_POINT * args[1].shape[0] * n_w
    else:
        cells = reducer_tap_cells(*(t[None] for t in args[:5]), args[5], red)
        n_bytes = 4 * (cells + args[1].numel() + 2 * n_w + args[3].numel() + 2 + args[1].shape[0])
        n_ops = reducer_ops(red) * args[1].shape[0] * n_w
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score K={args[1].shape[0]} {red.kind} {tuple(args[0].shape)}: device "
          f"{device_ms * 1e3:.2f} us (50 launches replayed from a CUDA graph), a call {ms:.4f} ms, "
          f"chained {chained:.4f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.7f} ms by {by} "
          f"({n_bytes} B, {n_ops} operations)", flush=True)
    return {"device_ms": device_ms, "ms": ms, "chained_ms": chained, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "n_bytes": n_bytes, "n_ops": n_ops}


def phase_polar_kernel(dev, scans, gt):
    """`polar_free_plane` vs its plain twin at the main path's shape and at
    edge cases; returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.models import viny
    from slam_constructor_tpu_torch.ops import kernels, raycast
    from slam_constructor_tpu_torch.utils import datagen

    beam = viny.viny_config(map_size=MAP).beam
    hole_half, max_range, scale = beam.hole_width / 2.0, beam.max_range, 0.1
    occ, w_origin, w_scale = datagen.cecum_world(device=dev)

    def origin_of(h, w):
        return torch.tensor([-w * scale / 2.0, -h * scale / 2.0], device=dev)

    def cast(pose, bearings):
        return raycast.cast_rays(occ, w_origin, w_scale, pose, bearings)

    every7 = torch.arange(N_BEAMS, device=dev) % 7 != 3
    s40, p40 = scans[40], gt[40]
    p_mid = torch.tensor([0.3, -1.45, 0.7], device=dev)
    p_edge = torch.tensor([6.6, -2.0, 2.5], device=dev)  # in the corridor's corner
    s_half = cast(p_mid, datagen.default_bearings(181, fov=math.pi, device=dev))
    s120 = cast(p_mid, datagen.default_bearings(120, device=dev))
    s90 = cast(p_mid, datagen.default_bearings(90, device=dev))
    s_edge = cast(p_edge, datagen.default_bearings(N_BEAMS, device=dev))
    cases = [
        ("main 256^2 R=360", s40.ranges, s40.valid, s40.bearings, p40, MAP, MAP),
        ("every 7th beam invalid", s40.ranges, s40.valid & every7, s40.bearings, p40, MAP, MAP),
        ("half field of view R=181", s_half.ranges, s_half.valid, s_half.bearings, p_mid, MAP, MAP),
        ("R=120", s120.ranges, s120.valid, s120.bearings, p_mid, MAP, MAP),
        ("R=90, 96 x 128 map", s90.ranges, s90.valid, s90.bearings, p_mid, 96, 128),
        ("pose near the map's edge", s_edge.ranges, s_edge.valid, s_edge.bearings, p_edge, 56, 144),
        ("all beams invalid", s40.ranges, torch.zeros_like(s40.valid), s40.bearings, p40, MAP, MAP),
    ]
    max_err, max_rel, flipped_all = 0.0, 0.0, 0
    for name, ranges, valid, bearings, pose, h, w in cases:
        args = (ranges.contiguous(), valid.contiguous(), bearings.contiguous(), pose.contiguous(),
                origin_of(h, w), h, w, scale, hole_half, max_range)
        got = kernels.polar_free_plane(*args)
        want = kernels.polar_free_plane_ref(*args)
        torch.cuda.synchronize()
        check(got.shape == (h, w) and bool(torch.isfinite(got).all()),
              f"polar_free_plane output malformed ({name})")
        flipped = int(((got > 0) != (want > 0)).sum())
        both = (got > 0) & (want > 0)
        n_free = int(both.sum())
        err = float((got - want).abs()[both].max()) if n_free else 0.0
        rel = float(((got - want).abs() / want.clamp(min=1e-30))[both].max()) if n_free else 0.0
        same = torch.equal(bits(got), bits(want))
        print(f"polar_free_plane vs plain [{name}]: {h}x{w} R={ranges.shape[0]} "
              f"free cells {n_free}, flipped {flipped} (allowed 0), max rel weight diff "
              f"{rel:.3e}; bit for bit: {same}", flush=True)
        check(flipped == 0, f"polar_free_plane: {flipped} cells flipped ({name})")
        check(same, f"polar_free_plane differs from its plain version ({name}): {rel}")
        if name.startswith("all beams invalid"):
            check(n_free == 0 and not bool(got.any()), "free cells without a valid beam")
        else:
            check(n_free > 200, f"polar_free_plane opened no free space ({name})")
        max_err, max_rel, flipped_all = max(max_err, err), max(max_rel, rel), flipped_all + flipped

    args = (s40.ranges.contiguous(), s40.valid.contiguous(), s40.bearings.contiguous(),
            p40.contiguous(), origin_of(MAP, MAP), MAP, MAP, scale, hole_half, max_range)
    ms, plain_ms, chained = time_pair(lambda: kernels.polar_free_plane(*args),
                                      lambda: kernels.polar_free_plane_ref(*args))
    # ranges and bearings f32, valid 1 B a beam, pose, origin; the plane out
    n_bytes = 4 * MAP * MAP + N_BEAMS * (4 + 4 + 1) + 12 + 8
    # what this scan needs: the full arithmetic only for the cells some beam
    # could reach, the distance test alone for the others
    rng_eff, _, _ = kernels.polar_range_table(*args[:3])
    cells = torch.arange(MAP, device=dev, dtype=torch.float32)
    cy, cx = (args[4][1] + (cells + 0.5) * scale)[:, None], (args[4][0] + (cells + 0.5) * scale)[None]
    d = torch.sqrt((cx - p40[0]) ** 2 + (cy - p40[1]) ** 2)
    n_near = int((d < min(max_range, float(rng_eff.max()) - hole_half)).sum())
    n_ops = POLAR_OPS_PER_CELL * n_near + POLAR_OPS_PER_FAR_CELL * (MAP * MAP - n_near)
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"polar_free_plane 256^2 R=360: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 100 calls each, CUDA events), kernel {chained:.4f} ms a launch over 200 "
          f"back to back; bound {b_ms:.6f} ms by {by} ({n_bytes} B; {n_ops} operations: "
          f"{n_near} of {MAP * MAP} cells within a beam's reach); no single PyTorch call "
          f"computes it", flush=True)
    return {
        "name": "polar_free_plane", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/polar_free.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:186",
        "max_abs_err": max_err, "max_rel_err": max_rel, "flipped_cells": flipped_all,
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def bits(t):
    """A float tensor as integers, so that NaN compares equal to itself."""
    return t.reshape(-1).view(torch.int32)


@contextlib.contextmanager
def handed_in(fn, name="mc_match", module=None):
    """``fn`` stands in the package's ``kernels.mc_match`` (or another
    function of a module of the package) while the block runs, so an engine
    run goes through it. A stand-in for ``mc_match`` also takes the place of
    ``kernels.mc_match_scan`` (a single match from the scan and the
    odometry), handed ``mc_match``'s arguments (``kernels.scan_match_args``:
    the prior and the scan's points as the package computes them)."""
    from slam_constructor_tpu_torch.ops import kernels

    module = module or kernels
    kept = getattr(module, name)
    setattr(module, name, fn)
    scan_kept = None
    if module is kernels and name == "mc_match":
        scan_kept = kernels.mc_match_scan
        kernels.mc_match_scan = lambda *a: fn(*kernels.scan_match_args(*a))
    try:
        yield
    finally:
        setattr(module, name, kept)
        if scan_kept is not None:
            kernels.mc_match_scan = scan_kept


def recorder(fn, every=1, keep=None):
    """``fn`` with the arguments of every ``every``-th call kept (of the
    calls ``n`` for which ``keep(n)`` holds, where it is given): returns the
    stand-in and the list it fills."""
    from slam_constructor_tpu_torch.ops import kernels

    kept, n = [], [0]

    def replayable(a):
        # a match's own draws (a key) kept as the draws themselves, which
        # give its bits; the key kept on them for the key route's check
        if isinstance(a, kernels.KeyNoise):
            d = kernels.ErfInvDraws(a.draws()[1])
            KEYED_DRAWS[id(d)] = kernels.KeyNoise(a.key.clone(), a.rounds, a.batch, a.step)
            return d
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recording(*args):
        if (keep(n[0]) if keep else n[0] % every == 0):
            kept.append(tuple(replayable(a) for a in args))
        n[0] += 1
        return fn(*args)

    return recording, kept


#: the KeyNoise each recorded ErfInvDraws was drawn from, by the draws' id
KEYED_DRAWS: dict = {}


def draws_of(noise):
    """A match's handed-in draws as a tensor: the normals, or the values of
    an ``ErfInvDraws`` (a recorded match that drew from a key)."""
    from slam_constructor_tpu_torch.ops import kernels

    return noise.values if isinstance(noise, kernels.ErfInvDraws) else noise


def capture_match_states(cfg, scans, odom, gt, every=32):
    """One run of the main path (it also warms the path up) that keeps the
    arguments of every ``every``-th match."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.mc_match, every)
    with handed_in(recording):
        run_main_path(cfg, scans, odom, gt, 0)
    return kept


def with_noise(args, rounds, batch, gen, bad_rounds=None):
    a = list(args)
    a[5] = torch.randn((rounds, batch, 3), generator=gen, device=a[4].device)
    if bad_rounds is not None:
        a[10] = bad_rounds
    return tuple(a)


def match_cases(tiny_states, viny_states, full_states, dev):
    """(name, args of mc_match): the captured states and the edge cases."""
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [(f"tiny scan {32 * i}", a) for i, a in enumerate(tiny_states)]
    cases += [(f"viny scan {32 * i}", a) for i, a in enumerate(viny_states)]
    cases += [(f"full scan {32 * i}", a) for i, a in enumerate(full_states)]
    # scans 96, 160 and 288: a map with walls on it; the last on the second lap
    t, v, f = tiny_states[3], viny_states[5], full_states[FULL_TIMED_STATE]
    for batch in (8, 32, 64, 96, 100):
        cases.append((f"tiny state, batch {batch}", with_noise(t, 12, batch, g)))
        cases.append((f"viny state, batch {batch}", with_noise(v, 16, batch, g)))
        cases.append((f"full state (window), batch {batch}", with_noise(f, 12, batch, g)))
    for rounds in (0, 1):
        cases.append((f"tiny state, rounds={rounds}", with_noise(t, rounds, 64, g)))
        cases.append((f"viny state, rounds={rounds}, batch 20", with_noise(v, rounds, 20, g)))
    cases.append(("viny state, anneal after every bad round", with_noise(v, 16, 64, g, 1)))

    def replaced(args, **kw):
        names = ("plane", "pts", "beam_w", "origin", "init_pose", "noise")
        return tuple(kw.get(n, a) for n, a in zip(names, args)) + tuple(args[6:])

    cases.append(("no valid beam", replaced(t, beam_w=torch.zeros_like(t[2]))))
    edge = torch.tensor([12.3, -1.5, 0.4], device=dev)  # the map ends at x = 12.8
    cases.append(("prior 0.5 m from the map's edge", replaced(t, init_pose=edge)))
    cases.append(("noise of zeros: every round ties",
                  replaced(v, noise=torch.zeros(tuple(v[5].shape), device=dev))))
    # the recorded draws are the reference's erf_inv values (kernels.ErfInvDraws)
    twice = t[5].values.clone()
    half = twice.shape[1] // 2
    twice[:, half:] = twice[:, :half]  # every candidate has an equal half a batch on
    cases.append(("every candidate twice: the first wins",
                  replaced(t, noise=type(t[5])(twice))))
    nan_w = v[2].clone()
    nan_w[5] = float("nan")
    cases.append(("a NaN beam weight: NaN scores, never better", replaced(v, beam_w=nan_w)))
    cases.append(("full state, no valid beam", replaced(f, beam_w=torch.zeros_like(f[2]))))
    # the window's origin is shifted: a prior 0.4 m inside its far corner
    reach = f[0].shape[0] * f[6] - 0.4
    corner = torch.cat([f[3] + reach, f[4][2:]])
    cases.append(("full state, prior in the window's corner", replaced(f, init_pose=corner)))
    return cases


def twin_record(args, loop=None, twin_score=None):
    """The plain twin's match with, for every round, how closely it was
    decided: the gap between its two best scores and between the best and
    the best so far. Returns (pose, prob, trace), margins f32[rounds]; with
    a leading particle dimension on the arguments, of every particle
    (margins f32[P, rounds]). ``loop`` and ``twin_score`` default to the
    Monte-Carlo match over ``overlap_score_ref``; a refine's loop and score
    twin (which may return the gradient too) give a refine's margins."""
    from slam_constructor_tpu_torch.ops import kernels

    loop = loop or kernels.mc_match_loop
    twin_score = twin_score or kernels.overlap_score_ref
    scores = []

    def score(*a):
        out = twin_score(*a)
        scores.append(out[0] if isinstance(out, tuple) else out)
        return out

    out = loop(score, *args)
    best, margins = scores[0][..., 0], []
    for probs in scores[1:]:
        top = torch.topk(probs, min(2, probs.shape[-1]), dim=-1).values
        gap = ((top[..., 0] - top[..., -1]).abs() if top.shape[-1] > 1
               else torch.full_like(best, math.inf))
        margins.append(torch.minimum(gap, (top[..., 0] - best).abs()))
        best = torch.maximum(best, top[..., 0])
    return out, (torch.stack(margins, dim=-1) if margins
                 else torch.empty((*best.shape, 0), device=best.device))


def against_twin(name, got, twin, margins, pose_tol=1e-6):
    """One match's (pose, prob, trace) against its plain twin's: within TOL
    round by round; where they part, a round decided by less than
    KNIFE_EDGE must come before. The poses agree within ``pose_tol`` unless
    a decision was that close. Returns (the largest difference up to there,
    whether they parted)."""
    n_rounds = got[2].shape[0]
    diff = (got[2] - twin[2]).abs()
    diff = torch.where(torch.isnan(got[2]) & torch.isnan(twin[2]), 0.0, diff)
    far = (diff > TOL).nonzero().flatten().tolist()
    first = far[0] if far else n_rounds
    err = float(diff[:first].max()) if first else 0.0
    if far:
        edge = float(margins[:first + 1].min())
        print(f"  [{name}] parts from the twin at round {first}; closest decision up to there "
              f"{edge:.3e} (limit {KNIFE_EDGE:g})", flush=True)
        check(edge < KNIFE_EDGE, f"a match parts from its twin with no close decision ({name})")
        return err, True
    p_err = float((got[1] - twin[1]).abs().nan_to_num(nan=0.0))
    pose_err = float((got[0] - twin[0]).abs().max())
    check(p_err <= TOL, f"match prob differs from its twin ({name}): {p_err}")
    check(pose_err <= pose_tol or float(margins.min()) < KNIFE_EDGE,
          f"match pose differs from its twin ({name}): {pose_err}")
    return max(err, p_err), False


def singles_of(fn, args):
    """``fn`` (a single-match wrapper) on each particle's slices of the
    batched args, stacked: (pose, prob, trace)."""
    n_p = args[0].shape[0]
    out = [fn(*(t[m] for t in args[:6]), *args[6:]) for m in range(n_p)]
    return [torch.stack([o[i] for o in out]) for i in range(3)]


def held_to_singles(name, got, args):
    """A batched particle match ``got`` equal, bit for bit, to single
    ``mc_match`` launches and ``mc_match_rounds`` on each particle."""
    from slam_constructor_tpu_torch.ops import kernels

    for ref, by in ((singles_of(kernels.mc_match, args), "single-plane mc_match launches"),
                    (singles_of(kernels.mc_match_rounds, args), "mc_match_rounds")):
        for i, part in enumerate(("pose", "prob", "trace")):
            check(torch.equal(bits(got[i]), bits(ref[i])),
                  f"mc_match_batched {part} differs from {by} ({name})")


def phase_mc_match(dev, tiny_states, viny_states, full_states):
    """`mc_match` vs `mc_match_rounds` (bitwise) and vs `mc_match_ref` over
    real states of the three main paths and edge cases; then the three
    timed at each path's shapes. Returns the `kernels` entry without the
    launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    f = full_states[FULL_TIMED_STATE]
    check((tuple(f[0].shape), f[1].shape[0], tuple(f[5].shape)) == ((192, 192), 180, (12, 64, 3)),
          f"the full path's match is {tuple(f[0].shape)} R'={f[1].shape[0]} noise "
          f"{tuple(f[5].shape)}, not a 192^2 window, 180 beams and 12 rounds of 64")
    cases = match_cases(tiny_states, viny_states, full_states, dev)
    max_err, parted = 0.0, 0
    for name, args in cases:
        got = kernels.mc_match(*args)
        rounds = kernels.mc_match_rounds(*args)
        (twin, margins) = twin_record(args)
        torch.cuda.synchronize()
        n_rounds, batch = args[5].shape[0], args[5].shape[1]
        check(got[0].shape == (3,) and got[1].shape == () and got[2].shape == (n_rounds,),
              f"mc_match output malformed ({name})")
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, rounds))
        check(same, f"mc_match differs from mc_match_rounds ({name}): pose {got[0].tolist()} vs "
                    f"{rounds[0].tolist()}, max |trace diff| "
                    f"{float((got[2] - rounds[2]).abs().nan_to_num(nan=0.0).max()) if n_rounds else 0.0}")
        err, apart = against_twin(name, got, twin, margins)
        parted += apart
        max_err = max(max_err, err)
        print(f"mc_match [{name}]: K={batch} rounds={n_rounds} R'={args[1].shape[0]} "
              f"{args[0].shape[0]}x{args[0].shape[1]} equal to "
              f"mc_match_rounds bit for bit; vs plain twin max|diff|={err:.3e} over the rounds "
              f"{'before they part' if apart else 'all'} (tol {TOL:g})", flush=True)
    print(f"mc_match: {len(cases)} cases equal to mc_match_rounds bit for bit; {parted} part from "
          f"the plain twin after a round decided by less than {KNIFE_EDGE:g}", flush=True)

    entry = {}
    for preset, args in (("tiny", tiny_states[3]), ("viny", viny_states[5]),
                         ("full", full_states[FULL_TIMED_STATE])):
        ms, plain_ms, chained = time_pair(lambda: kernels.mc_match(*args),
                                          lambda: kernels.mc_match_ref(*args), plain_calls=10)
        rounds_ms = statistics.median(time_ms(lambda: kernels.mc_match_rounds(*args), 20))
        n_rounds, batch = args[5].shape[0], args[5].shape[1]
        # the distinct plane cells the taps of every scored pose read, the
        # weighted beams' points, every weight, origin, prior and noise read
        # once; pose, prob and trace written once
        cells, sectors = tap_cells(args[0], visited_poses(kernels.mc_match_loop,
                                                          kernels.overlap_score, args),
                                   args[1], args[2], args[3], args[6])
        n_w = int((args[2] != 0).sum())
        n_bytes = 4 * (cells + 2 * n_w + args[2].numel() + 2 + 3 + args[5].numel()
                       + 3 + 1 + n_rounds)
        n_ops = OVERLAP_OPS_PER_POINT * (1 + n_rounds * batch) * n_w
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"mc_match {preset} K={batch} rounds={n_rounds} R'={args[1].shape[0]} "
              f"{args[0].shape[0]}x{args[0].shape[1]}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, one overlap_score launch a round "
              f"{rounds_ms:.4f} ms (medians of 100, 20 and 20 calls, CUDA events), kernel "
              f"{chained:.4f} ms a launch over 200 back to back; bound {b_ms:.6f} ms by {by} "
              f"({n_bytes} B: {cells} tap cells in {sectors} 32-B sectors; {n_ops} operations); "
              f"no single PyTorch call computes it", flush=True)
        entry[preset] = {"ms": ms, "plain_ms": plain_ms, "rounds_ms": rounds_ms,
                         "chained_ms": chained, "bound_ms": b_ms, "bound_by": by,
                         "tap_cells": cells}
    return {
        "name": "mc_match", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/mc_match.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "cases_bitwise_equal_to_rounds": len(cases),
        "cases_parted_from_twin": parted, **entry["viny"], "by_path": entry,
        "library_ms": None,
    }


def phase_card_vs_cpu(name, cfg, dev, scans, odom, gt, n=8):
    """First ``n`` scans on the card and on the CPU with the same noise (a
    Monte-Carlo matcher's; M3RSM draws none): poses within 1e-4, or, where
    the runs part, the scan's calls must explain it
    (``knife_edge_part``)."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import kernels

    noise = None
    if cfg.matcher == "monte_carlo":
        rounds, batch = cfg.matcher_cfg.rounds, cfg.matcher_cfg.batch
        noise = torch.from_numpy(
            np.random.default_rng(5).standard_normal((n, rounds, batch, 3)).astype(np.float32))
    trajs, calls = [], []
    for d in (dev, torch.device("cpu")):
        matches, climbs = recorder(kernels.mc_match), recorder(kernels.hill_climb)
        with handed_in(matches[0]), handed_in(climbs[0], "hill_climb"):
            e = engine.Engine(cfg, device=d)
            e.state.pose = gt[0].to(d).clone()
            traj, _ = e.run(scans[:n], odom[:n], noise=None if noise is None else noise.to(d))
        trajs.append(traj.cpu())
        calls.append({"match": matches[1], "refine": climbs[1]})
    d = trajs[0] - trajs[1]
    d[..., 2] = torch.atan2(torch.sin(d[..., 2]), torch.cos(d[..., 2]))
    by_scan = d.abs().amax(-1)
    diff = float(by_scan.max())
    part = int((by_scan > 1e-4).nonzero()[0]) if diff > 1e-4 else None
    print(f"{name} card vs CPU, {n} scans: max|pose diff|={diff:.3e} (tol 1e-4)"
          f"{'' if part is None else f'; the runs part at scan {part}'}", flush=True)
    check(part is None or knife_edge_part(name, part, n, *calls),
          f"{name}: card and CPU runs disagree: {diff}, not at a knife-edge decision")


def knife_edge_part(name, part, n, card, cpu) -> bool:
    """Why a single-hypothesis run parts on the card and the CPU at scan
    ``part``: ``card`` and ``cpu`` hold each device's recorded calls
    (``"match"``: ``mc_match``, ``"refine"``: ``hill_climb``; one a scan
    over ``n`` scans). In the scan's order, the card's kernel is run again
    on the card's arguments and the plain twin on the CPU's (the CPU run's
    own call), round by round. Explained when the first call whose traces
    part by more than TOL (or whose poses part by more than 1e-5) agrees
    with the twin up to a round that the CPU decided by less than
    KNIFE_EDGE: the card took the other side of that decision. A call that
    parts with no such round, or a scan in which no call parts, is not
    explained."""
    from slam_constructor_tpu_torch.ops import kernels

    for kind, kernel, loop in (("match", kernels.mc_match, kernels.mc_match_loop),
                               ("refine", kernels.hill_climb, kernels.hill_climb_loop)):
        if len(card[kind]) != n or len(cpu[kind]) != n:
            continue
        card_args, cpu_args = card[kind][part], cpu[kind][part]
        got = [t.cpu() for t in kernel(*card_args)]
        twin, margins = twin_record(cpu_args, loop, kernels.overlap_score_ref)
        start = pose_gap(card_args[4].cpu(), cpu_args[4])
        diff = (got[2] - twin[2]).abs()
        diff = torch.where(torch.isnan(got[2]) & torch.isnan(twin[2]), 0.0, diff)
        far = (diff > TOL).nonzero().flatten().tolist()
        apart = pose_gap(got[0], twin[0])
        if not far and apart <= 1e-5:
            print(f"  [{name}] scan {part}: the card's {kind} on its arguments equals the twin on "
                  f"the CPU's (start poses {start:.3e} apart; trace within {TOL:g}, poses "
                  f"{apart:.3e} apart)", flush=True)
            continue
        first = far[0] if far else margins.numel() - 1
        edge_round = int(margins[:first + 1].argmin()) if first >= 0 else None
        edge = float(margins[edge_round]) if edge_round is not None else math.inf
        print(f"  [{name}] scan {part}: the card's {kind} on its arguments and the twin on the "
              f"CPU's (start poses {start:.3e} apart) part "
              + (f"at round {first} of the trace" if far else "in the pose only")
              + f" (poses {apart:.3e} apart); the CPU's closest decision up to there: round "
              f"{edge_round}, {edge:.3e} (limit {KNIFE_EDGE:g})", flush=True)
        return edge < KNIFE_EDGE
    print(f"  [{name}] scan {part}: no recorded call of the scan parts", flush=True)
    return False


def run_main_path(cfg, scans, odom, gt, sync_mode, seed=0):
    """One run of the sequence from a fresh state through the entry points
    a user calls; the engine takes the card because no device is named,
    and draws from the reference's ``PRNGKey(seed)``."""
    from slam_constructor_tpu_torch.models import engine

    e = engine.Engine(cfg, seed=seed)
    check(e.device.type == "cuda", f"Engine defaulted to {e.device}, not the card")
    e.state.pose = gt[0].clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(sync_mode)
    t0 = time.perf_counter()
    traj, probs = e.run(scans, odom)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return traj, probs, time.perf_counter() - t0, e


def phase_main_path(name, cfg, want_launches, scans, odom, gt, odo_ate, ate_limit, want_libm):
    """The timed run (the path was warmed up by the run that captured the
    match states) with the counts at 0 before and read after (libm's, by
    function, against ``want_libm``), then once more for repeatability;
    returns the launch counts, the trajectory and the engine of the timed
    run."""
    from slam_constructor_tpu_torch.utils import evaluate

    reset_launches()
    traj, probs, secs, e = run_main_path(cfg, scans, odom, gt, "error")
    launches = read_launches()
    LIBM_BY_PATH[name] = dict(LAST_LIBM)
    print(f"{name} main path: {N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} scans/s "
          f"with the sync check on, no host sync; launches {launches} "
          f"(expected {want_launches}); libm {LAST_LIBM}", flush=True)
    check(launches == want_launches, f"{name}: launches {launches}, expected {want_launches}")
    check_libm(name, want_libm)
    check(traj.shape == (N_SCANS, 3) and bool(torch.isfinite(traj).all()),
          f"{name}: non-finite poses")
    ate = float(evaluate.ate(traj, gt, align=False))
    print(f"{name} main path: ATE {ate:.4f} m (no alignment; limit {ate_limit:.4f}), "
          f"odometry-only ATE {odo_ate:.4f} m, min prob {float(probs[1:].min()):.4f}", flush=True)
    check(ate < odo_ate and ate <= ate_limit,
          f"{name}: ATE {ate} not below odometry {odo_ate} and {ate_limit}")
    traj2, _, secs2, _ = run_main_path(cfg, scans, odom, gt, 0)
    rep = float((traj2 - traj).abs().max())
    print(f"{name} repeatability: max|pose diff| between two runs {rep:.3e}; second run, "
          f"sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(torch.equal(traj2, traj), f"{name}: two runs differ by {rep}")
    return launches, traj, e


def expect(**counts) -> dict:
    """The launch counts of every kernel wrapper: those named, 0 the rest."""
    from slam_constructor_tpu_torch.ops import kernels

    return {name: counts.get(name, 0) for name in kernels.launch_counts()}


def reset_launches() -> None:
    from slam_constructor_tpu_torch.ops import kernels

    kernels.reset_launch_counts()


def read_launches() -> dict:
    """The kernel wrappers' launch counts; ``csrc/libm.cu``'s, counted apart
    by function, are kept in ``LAST_LIBM``."""
    from slam_constructor_tpu_torch.ops import kernels

    LAST_LIBM.clear()
    LAST_LIBM.update(kernels.libm_launch_counts())
    return kernels.launch_counts()


#: libm's launches by function at the last read_launches(), and by main path
LAST_LIBM: dict = {}
LIBM_BY_PATH: dict = {}

#: ``csrc/libm.cu``'s launches a scan by function on each kind of path (its
#: Python-level sites: the RBPF's proposal, weights and resampling; the
#: M3RSM match's prior and points; full's window corner and keyframe test).
#: The single-map Monte-Carlo match computes its prior and its scan's points
#: in its own prologue (``kernels.mc_match_scan``) and viny's weights are one
#: ``beam_weights`` launch: tiny and viny launch none.
LIBM_A_SCAN = {
    "tiny": {},
    "viny": {},
    "viny_m3rsm": {"pose/compose": 1, "cossin": 1},
    # the tracker of the full path: the prior its match window is cut
    # around, the keyframe test's between, distance and heading
    "full tracking": {"pose/compose": 1, "pose/between": 1, "sqrt": 1, "wrap_angle": 1},
    # the proposal's fused multiply-add (its erf_inv draws times sqrt(2)
    # sigma, plus the odometry) and its two composes
    "gmapping": {"pose/compose": 2, "fma32": 1, "cossin": 1, "log": 1, "rows/normalize": 2,
                 "rows/ess": 2, "rows/softmax": 1},
    # the improved proposal (and its gate) adds the probes' headings, the
    # motion prior's frame, the fit's spread and a second softmax
    "gmapping improved": {"pose/compose": 2, "fma32": 1, "cossin": 3, "wrap_angle": 4,
                          "sincos": 1, "log": 1, "sqrt": 1, "rows/normalize": 2, "rows/ess": 2,
                          "rows/softmax": 2},
}


def expect_libm(kind: str, n: int = N_SCANS) -> dict:
    """libm's launches by function of ``n`` scans of a path of ``kind``
    (:data:`LIBM_A_SCAN`), with their ``total``."""
    want = {name: n * k for name, k in LIBM_A_SCAN[kind].items()}
    return {**want, "total": sum(want.values())}


def check_libm(name: str, want: dict, got: dict | None = None) -> None:
    """libm's launches by function (the last read_launches(), or ``got``)
    against ``want``: a site that launches more often, or a new one, is
    printed at once and fails the run at its end (``LIBM_PARTED``), so one
    run names every path's counts."""
    got = {k: v for k, v in (LAST_LIBM if got is None else got).items() if v}
    if got != {k: v for k, v in want.items() if v}:
        LIBM_PARTED.append(f"{name}: libm launches {got}, expected {want}")
        print(f"libm counts part: {LIBM_PARTED[-1]}", flush=True)


#: the paths whose libm launches parted from their expected counts
LIBM_PARTED: list = []


def phase_rounds_path(cfg, scans, odom, gt, fused_traj):
    """The first scans of the viny path with `mc_match_rounds` handed in in
    the fused kernel's place: the same trajectory bit for bit, and the
    launches of `overlap_score` it takes."""
    from slam_constructor_tpu_torch.ops import kernels

    n = ROUNDS_PATH_SCANS
    with handed_in(kernels.mc_match_rounds):
        reset_launches()
        traj, _, secs, _ = run_main_path(cfg, scans[:n], odom[:n], gt, "error")
        launches = read_launches()
    want = expect(overlap_score=n * (cfg.matcher_cfg.rounds + 1), polar_free_plane=n,
                  scan_insert=n, beam_weights=n)
    diff = float((traj - fused_traj[:n]).abs().max())
    print(f"viny path with one overlap_score launch a round, {n} scans: {n / secs:.1f} scans/s; "
          f"launches {launches} (expected {want}); max|pose diff| to the fused path {diff:.3e}",
          flush=True)
    check(launches == want, f"rounds path: launches {launches}, expected {want}")
    # the yardstick is handed the prior and the scan's points (a compose and
    # a cossin launch a scan) and forms each round's candidates in torch: an
    # fma32 and a wrap_angle launch a round
    rounds = cfg.matcher_cfg.rounds
    want_libm = expect_libm("viny", n)
    want_libm.update({"pose/compose": n, "cossin": n, "fma32": rounds * n,
                      "wrap_angle": rounds * n, "total": want_libm["total"] + 2 * (rounds + 1) * n})
    check_libm("rounds path", want_libm)
    check(torch.equal(traj, fused_traj[:n]),
          f"the fused match and one launch a round give different trajectories: {diff}")
    return launches


def run_full_path(cfg, scans, odom, gt, sync_mode, noise=None, device=None, seed=0):
    """One run of the loop-closing pipeline from a fresh state through
    ``FullSlamEngine.run``, the whole sequence as one segment; the sync
    check is on only while the segment is tracked (the graph work that
    follows fetches its counters by design). Returns the engine, the
    corrected trajectory, the seconds of the whole run and of the tracking.
    libm's launches while the segment is tracked are kept in
    ``TRACK_LIBM``."""
    from slam_constructor_tpu_torch.models import full
    from slam_constructor_tpu_torch.ops import kernels

    TRACK_LIBM.clear()
    e = full.FullSlamEngine(cfg, n_beams=N_BEAMS, device=device, seed=seed)
    on_card = e.device.type == "cuda"
    check(device is not None or on_card, f"FullSlamEngine defaulted to {e.device}, not the card")
    e.state.pose = gt[0].to(e.device).clone()
    tracked, track_secs = full.track_segment, [0.0]

    def guarded(*args, **kwargs):
        t0 = time.perf_counter()
        before = kernels.libm_launch_counts()
        if on_card:
            torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            out = tracked(*args, **kwargs)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
        track_secs[0] += time.perf_counter() - t0
        for name, n in kernels.libm_launch_counts().items():
            TRACK_LIBM[name] = TRACK_LIBM.get(name, 0) + n - before.get(name, 0)
        return out

    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with handed_in(guarded, "track_segment", full):
        traj = e.run(scans, odom, segment=len(scans), noise=noise)
    if on_card:
        torch.cuda.synchronize()
    return e, traj, time.perf_counter() - t0, track_secs[0]


#: libm's launches by function while the last run_full_path() tracked
TRACK_LIBM: dict = {}


def capture_full_launches(cfg, scans, odom, gt, every=32):
    """A run of the full path (it also warms the path up) that keeps the
    arguments of every ``every``-th match and of every launch of
    ``overlap_score_batched``."""
    from slam_constructor_tpu_torch.ops import kernels

    match, states = recorder(kernels.mc_match, every)
    batched, kept = recorder(kernels.overlap_score_batched)
    with handed_in(match), handed_in(batched, "overlap_score_batched"):
        run_full_path(cfg, scans, odom, gt, 0)
    return states, kept


def graph_bits(e):
    """Everything of an engine's graph, map and live pose, as one list of
    tensors, for comparing two runs bit for bit."""
    g = e.graph
    return [g.kf_poses, g.kf_scans.ranges, g.kf_scans.valid, g.n_kf, g.edge_i, g.edge_j,
            g.edge_delta, g.edge_info, g.edge_is_loop, g.n_edges, g.last_kf, e.state.gm.cells,
            e.state.pose]


def loop_match_launches(graph_cfg, calls: int) -> dict:
    """The launches of ``calls`` loop-closing matches (``_match_loop``, one
    a keyframe batch and one a densify round): the submaps' render, the
    matcher's over the submaps (``matcher_launches``: the brute-force grid a
    batched score; M3RSM its pyramid and the whole match; the hill climb or
    the gradient ascent one launch) and the information estimate, a batched
    score."""
    counts = {"overlap_score_batched": calls, "scan_planes": calls}
    for k, v in matcher_launches(graph_cfg.loop_matcher_kind, graph_cfg.loop_matcher).items():
        counts[k] = counts.get(k, 0) + v * calls
    return counts


def regeneration_counter():
    """A stand-in for ``posegraph.regenerate_map`` that notes each call, and
    the launches those calls take: for a cell model whose fold is additive
    one ``scan_planes`` a group of keyframes, else one ``scan_insert`` a
    keyframe (over ``min(n_used, max_keyframes)`` slots)."""
    from slam_constructor_tpu_torch.models import posegraph

    real, calls = posegraph.regenerate_map, []

    def counted(*args, **kwargs):
        cfg, model = args[0], args[1]
        n_used, group = kwargs.get("n_used"), kwargs.get("group", 32)
        kmax = cfg.max_keyframes if n_used is None else min(n_used, cfg.max_keyframes)
        calls.append((kmax, group, getattr(model, "fold_additive", False)))
        return real(*args, **kwargs)

    def launches():
        planes = sum(-(-k // max(g, 1)) for k, g, additive in calls if additive)
        inserts = sum(k for k, _, additive in calls if not additive)
        return {"scan_planes": planes, "scan_insert": inserts}

    return counted, launches


def phase_full_path(cfg, scans, odom, gt, odo_ate, name="full", reference=FULL_REFERENCE_ATE_BY_KEY,
                    hold_to_tracker=True):
    """The timed run of the full path with the counts at 0 before and read
    after, its checks (with ``hold_to_tracker``, ATE within the margin of
    the same tracker's without the graph), and once more for
    repeatability; returns the launch counts."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.utils import evaluate

    from slam_constructor_tpu_torch.models import posegraph

    counted, regenerations = regeneration_counter()
    with handed_in(counted, "regenerate_map", posegraph):
        reset_launches()
        e, traj, secs, track_secs = run_full_path(cfg, scans, odom, gt, "error")
        launches = read_launches()
    n_kf, n_edges = int(e.graph.n_kf), int(e.graph.n_edges)
    loops = loop_match_launches(cfg.graph, e.n_kf_batches + cfg.densify_rounds * e.n_bursts)
    regen = regenerations()
    want = expect(mc_match=N_SCANS,
                  **{**loops, "scan_insert": N_SCANS + regen["scan_insert"],
                                       "scan_planes": loops["scan_planes"] + regen["scan_planes"]})
    print(f"{name} main path: {N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} scans/s "
          f"(tracking {track_secs:.3f} s with the sync check on, no host sync; keyframe work and "
          f"bursts {secs - track_secs:.3f} s); {n_kf} keyframes in {e.n_kf_batches} batches, "
          f"{n_edges} edges, {e.total_loops} loops, {e.n_bursts} bursts; launches {launches} "
          f"(expected {want})", flush=True)
    check(launches == want, f"{name}: launches {launches}, expected {want}")
    # libm: the tracker's sites a scan exactly; the keyframe batches' and
    # bursts' (loop tests, the graph's Gauss-Newton steps) follow the
    # graph's data and are printed
    graph_libm = {k: v - TRACK_LIBM.get(k, 0) for k, v in LAST_LIBM.items()
                  if v - TRACK_LIBM.get(k, 0)}
    LIBM_BY_PATH[name] = dict(LAST_LIBM)
    print(f"{name} main path: libm launches while tracking {TRACK_LIBM}, in the keyframe work "
          f"and bursts {graph_libm}", flush=True)
    check_libm(f"{name} tracking", expect_libm("full tracking"), TRACK_LIBM)
    check(n_kf > 0 and e.total_loops >= 1, f"{name}: {n_kf} keyframes, {e.total_loops} loops")
    check(e.n_kf_batches == math.ceil(n_kf / cfg.kf_batch), f"{name}: keyframe batches do not add up")
    check(traj.shape == (N_SCANS, 3) and bool(torch.isfinite(traj).all()), f"{name}: non-finite poses")
    check(bool(torch.isfinite(e.occupancy).all()) and e.occupancy.shape == (MAP, MAP),
          f"{name}: the map is malformed")
    ate = float(evaluate.ate(traj, gt, align=False))
    raw_ate = float(evaluate.ate(torch.from_numpy(np.stack(e.trajectory)).to(gt.device), gt,
                                 align=False))
    # the same tracker without the graph, from the same key
    t = engine.Engine(cfg.tracking, seed=0)
    t.state.pose = gt[0].clone()
    tracker_ate = float(evaluate.ate(t.run(scans, odom)[0], gt, align=False))
    limit = max(reference) + FULL_ATE_MARGIN
    print(f"{name} main path: corrected-trajectory ATE {ate:.4f} m (no alignment; limits: the "
          f"reference's worst key + margin {limit:.4f}, the tracker alone + margin "
          f"{tracker_ate + FULL_ATE_MARGIN:.4f}{'' if hold_to_tracker else ', not held'}), as tracked {raw_ate:.4f} m, the same tracker "
          f"without the graph {tracker_ate:.4f} m, odometry only {odo_ate:.4f} m", flush=True)
    check(ate < odo_ate, f"{name}: ATE {ate} not below odometry's {odo_ate}")
    check(ate <= limit, f"{name}: ATE {ate} above the reference's worst key + margin {limit}")
    check(not hold_to_tracker or ate <= tracker_ate + FULL_ATE_MARGIN,
          f"{name}: the graph degrades the tracker: {ate} against {tracker_ate}")
    e2, traj2, secs2, _ = run_full_path(cfg, scans, odom, gt, 0)
    same = torch.equal(traj2, traj) and all(
        torch.equal(a, b) for a, b in zip(graph_bits(e), graph_bits(e2)))
    print(f"{name} repeatability: max|pose diff| between two runs "
          f"{float((traj2 - traj).abs().max()):.3e}, graph and map equal: {same}; second run, "
          f"sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(same, f"{name}: two runs differ")
    return launches


def batched_score_work(a):
    """(bytes, operations, tap cells) of one `overlap_score_batched` launch
    on ``a``: each map's distinct tap cells, its poses, its weighted beams'
    points, every weight and its origin read once, the scores written
    once; the operations of the beams that carry weight."""
    n_m, k = a[1].shape[:2]
    cells, _ = tap_cells_maps(*a[:6])
    n_w = int((a[3] != 0).sum())
    n_bytes = 4 * (cells + a[1].numel() + 2 * n_w + a[3].numel() + a[4].numel() + n_m * k)
    return n_bytes, OVERLAP_OPS_PER_POINT * k * n_w, cells


def phase_batched_kernel(dev, kept):
    """`overlap_score_batched` on the launches kept from a full run and on
    edge cases: against its plain twin and against M single-plane launches;
    then timed. Returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    grids = [a for a in kept if a[1].shape[1] > 7]
    sevens = [a for a in kept if a[1].shape[1] == 7]
    check(grids and sevens, "the full run launched no grid or no information estimate")
    big = max(grids, key=lambda a: a[0].shape[0])
    n_m, k = big[1].shape[:2]
    check((n_m, k, big[0].shape[1:], big[2].shape[1]) == (32, 343, (120, 120), 180),
          f"the widest kept launch is M={n_m} K={k} {tuple(big[0].shape[1:])} R'={big[2].shape[1]}")

    def sub(a, m):  # the maps m of a launch
        return tuple(t[m].contiguous() for t in a[:5]) + tuple(a[5:])

    def edited(a, i, t):
        return a[:i] + (t,) + a[i + 1:]

    no_beam = big[3].clone()
    no_beam[1] = 0.0
    shifted = torch.stack([big[2][m].roll(3 * m, 0) for m in range(n_m)])  # other points a map
    cases = [
        ("kept: the widest grid", big),
        ("kept: its information estimate", max(sevens, key=lambda a: a[0].shape[0])),
        ("kept: the narrowest grid", min(grids, key=lambda a: a[0].shape[0])),
        ("kept: every 16th launch", None),
        ("M=1", sub(big, slice(0, 1))),
        ("M=5", sub(big, slice(3, 8))),
        ("a map with no valid beam", edited(big, 3, no_beam)),
        ("differing points a map", edited(big, 2, shifted)),
        ("poses of map 0 far off their submap", edited(big, 1, big[1] + torch.tensor(
            [40.0, 0.0, 0.0], device=dev) * (torch.arange(n_m, device=dev) == 0)[:, None, None])),
    ]
    max_err = 0.0
    for name, args in cases:
        for a in (kept[::16] if args is None else [args]):
            got = kernels.overlap_score_batched(*a)
            want = kernels.overlap_score_ref(*a)
            singles = torch.stack([kernels.overlap_score(*sub(a, m)) for m in range(a[0].shape[0])])
            torch.cuda.synchronize()
            check(got.shape == a[1].shape[:2] and bool(torch.isfinite(got).all()),
                  f"overlap_score_batched output malformed ({name})")
            err = float((got - want).abs().max())
            check(err <= TOL, f"overlap_score_batched disagrees with its twin ({name}): {err}")
            check(torch.equal(bits(got), bits(singles)),
                  f"overlap_score_batched differs from single-plane launches ({name}): "
                  f"{float((got - singles).abs().max())}")
            check(args is None or torch.equal(bits(got), bits(kernels.overlap_score_ordered(*a))),
                  f"overlap_score_batched is not the group's sums ({name})")
            max_err = max(max_err, err)
        shape = "" if args is None else (f" M={args[0].shape[0]} K={args[1].shape[1]} "
                                         f"R'={args[2].shape[1]}")
        print(f"overlap_score_batched [{name}]:{shape} max|diff| to the plain twin so far "
              f"{max_err:.3e} (tol {TOL:g}); equal to single-plane launches bit for bit"
              + ("" if args is None else " and to the group's sums (overlap_score_ordered)"),
              flush=True)
    check(not bool(kernels.overlap_score_batched(*cases[6][1])[1].any()),
          "a map with no valid beam must score 0")

    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_batched(*big),
                                      lambda: kernels.overlap_score_ref(*big))
    singles_ms = statistics.median(time_ms(
        lambda: [kernels.overlap_score(*sub(big, m)) for m in range(n_m)], 20))
    n_bytes, n_ops, cells = batched_score_work(big)
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score_batched M={n_m} K={k} R'=180 120^2: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 100 calls each, CUDA events), kernel {chained:.4f} ms a "
          f"launch over 200 back to back, {n_m} single-plane launches {singles_ms:.4f} ms (median "
          f"of 20); bound {b_ms:.6f} ms by {by} ({n_bytes} B: {cells} tap cells; {n_ops} "
          f"operations); no single PyTorch call computes it", flush=True)
    return {
        "name": "overlap_score_batched", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "single_plane_launches_ms": singles_ms, "bound_ms": b_ms, "bound_by": by,
        "library_ms": None,
    }


def phase_full_card_vs_cpu(dev):
    """A short loop-closing run (a lap of the rectangle and 14 scans more,
    keyframe batches and closure bursts included) on the card and on the CPU
    with the same matcher noise."""
    n = 92
    scans, odom, gt = full_sequence(dev, n_scans=n, step=0.35, noise=(0.02, 0.012))
    cfg = full_config(optimize_every_loops=2)
    mc = cfg.tracking.matcher_cfg
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n, mc.rounds, mc.batch, 3)).astype(np.float32))
    runs = []
    for d in (None, "cpu"):
        e, traj, _, _ = run_full_path(cfg, scans, odom, gt, 0, noise=noise, device=d)
        runs.append((e, traj.cpu()))
    (a, ta), (b, tb) = runs
    diff = float((ta - tb).abs().max())
    n_e = int(a.graph.n_edges)
    same = (int(b.graph.n_edges) == n_e and int(a.graph.n_kf) == int(b.graph.n_kf)
            and a.total_loops == b.total_loops and a.n_bursts == b.n_bursts
            and torch.equal(a.graph.edge_i.cpu(), b.graph.edge_i)
            and torch.equal(a.graph.edge_j.cpu(), b.graph.edge_j))
    print(f"full card vs CPU, {n} scans: {int(a.graph.n_kf)} keyframes, {n_e} edges, "
          f"{a.total_loops} loops, {a.n_bursts} bursts on the card; the same graph structure on "
          f"the CPU: {same}; max|pose diff| of the corrected trajectory {diff:.3e} (tol 1e-3)",
          flush=True)
    check(a.total_loops >= 1 and a.n_bursts >= 1, "full card vs CPU: no loop closed")
    check(same, "full card vs CPU: the graphs differ in structure")
    check(diff <= 1e-3, f"full card vs CPU: trajectories disagree: {diff}")


def gmapping_config(**kwargs):
    """bench.py's ``gmapping`` preset: ``fast_config(n_particles=30,
    map_size=256)``."""
    from slam_constructor_tpu_torch.models import gmapping

    return gmapping.fast_config(n_particles=GM_PARTICLES, map_size=MAP, **kwargs)


def run_gmapping_path(cfg, scans, odom, gt, sync_mode, draws=None, device=None, make=None,
                      seed=0):
    """One RBPF run from a fresh state through ``GMappingEngine.run``; the
    engine (``GMappingEngine(cfg)``, or ``make(device=..., seed=0)``: a
    preset's factory) takes the card unless a device is named. Returns the
    engine, the best particle's trajectory, Neff and the seconds."""
    from slam_constructor_tpu_torch.models import gmapping

    e = (make or functools.partial(gmapping.GMappingEngine, cfg))(device=device, seed=seed)
    cfg = e.cfg
    on_card = e.device.type == "cuda"
    check(device is not None or on_card, f"GMappingEngine defaulted to {e.device}, not the card")
    e.state.poses = gt[0].to(e.device).expand(cfg.n_particles, 3).clone()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(sync_mode)
    t0 = time.perf_counter()
    try:
        traj, neffs = e.run(scans, odom, draws=draws)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return e, traj, neffs, time.perf_counter() - t0


def capture_particle_matches(cfg, scans, odom, gt, every=32):
    """A run of the gmapping path (it also warms the path up) that keeps
    the arguments of every ``every``-th particle match: the windows read in
    place (``mc_match_windows``)."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.mc_match_windows, every)
    with handed_in(recording, "mc_match_windows"):
        run_gmapping_path(cfg, scans, odom, gt, 0)
    return kept


def cut_out(a):
    """The args of ``mc_match_batched`` for the args ``a`` of
    ``mc_match_windows``: each window cut out of its map, where(known, occ,
    unknown), as ``kernels.mc_match_windows_ref`` does."""
    from slam_constructor_tpu_torch.ops import grid as gridlib

    occ, known, row, col, sh, sw = a[:6]
    plane = torch.where(gridlib.take_window(known, row, col, sh, sw),
                        gridlib.take_window(occ, row, col, sh, sw), a[12])
    return (plane.contiguous(), *a[6:])


def window_cases(states, dev):
    """(name, args of mc_match_windows): the captured states, the windows
    clamped at each of the map's four edges and corners, a window as large
    as the map, and the occupancy as a channel of the maps' cells."""
    from slam_constructor_tpu_torch.ops import grid as gridlib

    s = states[8]  # scan 256, on the second lap of the rectangle
    cases = [(f"gmapping scan {32 * i}, in place", a) for i, a in enumerate(states)]
    occ, known, _, _, sh, sw = s[:6]
    h, w = occ.shape[1:]
    scale = s[11]
    # the maps' origin, as gridlib.make_grid_map centres them
    map_origin = torch.tensor([-w * scale / 2.0, -h * scale / 2.0], device=dev).expand(
        occ.shape[0], 2).contiguous()
    far = 2.0 * max(h, w) * scale
    for name, dx, dy in (("left edge", -1, 0), ("right edge", 1, 0), ("bottom edge", 0, -1),
                         ("top edge", 0, 1), ("bottom-left corner", -1, -1),
                         ("bottom-right corner", 1, -1), ("top-left corner", -1, 1),
                         ("top-right corner", 1, 1)):
        centre = s[9][:, :2] + torch.tensor([dx * far, dy * far], device=dev)
        row, col, origin = gridlib.window_corner(map_origin, centre, scale, sh, sw, h, w)
        cases.append((f"windows clamped at the map's {name}",
                      (occ, known, row, col, sh, sw, s[6], s[7], origin, *s[9:])))
    zero = torch.zeros_like(s[2])
    cases.append((f"a window as large as the map ({h}x{w})",
                  (occ, known, zero, zero, h, w, s[6], s[7], map_origin, *s[9:])))
    cells = torch.stack([occ, known.to(torch.float32)], -1)  # as a Bayes cell map holds them
    cases.append(("occupancy a channel of the maps' cells", (cells[..., 0], cells[..., 1] > 0, *s[2:])))
    return cases


def particle_cases(states, dev):
    """(name, args of mc_match_batched): the captured states' windows cut
    out, and edge cases."""
    from slam_constructor_tpu_torch.ops import kernels

    g = torch.Generator(device=dev).manual_seed(11)
    states = [cut_out(a) for a in states]
    cases = [(f"gmapping scan {32 * i}, cut out", a) for i, a in enumerate(states)]
    s = states[8]  # scan 256, on the second lap of the rectangle

    def with_p_noise(a, rounds, batch):
        noise = torch.randn((a[0].shape[0], rounds, batch, 3), generator=g, device=dev)
        return a[:5] + (noise,) + a[6:]

    def sliced(a, sl):
        return tuple(t[sl].contiguous() for t in a[:6]) + a[6:]

    for batch in (1, 13, 64, 100):
        cases.append((f"K={batch}", with_p_noise(s, 5, batch)))
    cases.append(("0 rounds", with_p_noise(s, 0, 20)))
    no_beam = s[2].clone()
    no_beam[3] = 0.0
    cases.append(("particle 3 without a valid beam", s[:2] + (no_beam,) + s[3:]))
    cases.append(("P=1", sliced(s, slice(0, 1))))
    wide = tuple(torch.cat([states[4][i], states[8][i], states[12][i][:4]]) for i in range(5))
    noise = torch.cat([draws_of(states[4][5]), draws_of(states[8][5]),
                       draws_of(states[12][5])[:4]])
    wide += (noise if isinstance(states[4][5], torch.Tensor) else kernels.ErfInvDraws(noise),)
    cases.append(("P=64 (three scans' particles)", wide + s[6:]))
    return cases


def phase_particle_match(dev, states):
    """The particle match: `mc_match_windows` (the windows read in place,
    the main path's form) against `mc_match_batched` on the same windows
    cut out, against P single `mc_match` launches and `mc_match_rounds`
    (all bit for bit), on states of the gmapping path and edge cases; then
    `mc_match_batched` on the cut-out windows and edge cases against the
    same and against its plain twin; then timed at the path's shape, in
    turns with the windows cut out and matched (the path's form before they
    were read in place). Returns the `kernels` entry without the
    launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    s = states[8]
    check((tuple(s[0].shape), s[4:6], tuple(s[6].shape), tuple(s[10].shape)) ==
          ((GM_PARTICLES, MAP, MAP), (160, 160), (GM_PARTICLES, 180, 2), (GM_PARTICLES, 5, 20, 3)),
          f"the gmapping match reads {tuple(s[0].shape)} maps, {s[4:6]} windows, pts "
          f"{tuple(s[6].shape)}, noise {tuple(s[10].shape)}: not 30 maps of 256^2, 160^2 windows, "
          f"180 beams and 5 rounds of 20")

    n_in_place = 0
    for name, args in window_cases(states, dev):
        got = kernels.mc_match_windows(*args)
        cut = cut_out(args)
        want = kernels.mc_match_batched(*cut)
        torch.cuda.synchronize()
        n_p, n_rounds, k = args[10].shape[:3]
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
              f"mc_match_windows differs from mc_match_batched on the cut-out windows ({name})")
        held_to_singles(f"mc_match_windows, {name}", got, cut)
        n_in_place += n_p
        print(f"mc_match_windows [{name}]: P={n_p} K={k} rounds={n_rounds} R'={args[6].shape[1]} "
              f"{args[4]}x{args[5]} windows of {args[0].shape[1]}x{args[0].shape[2]} maps (cell "
              f"stride {args[0].stride(-1)}), rows {int(args[2].min())}..{int(args[2].max())}, cols "
              f"{int(args[3].min())}..{int(args[3].max())}: equal to mc_match_batched on the cut-out "
              f"windows, {n_p} single launches and mc_match_rounds bit for bit", flush=True)

    max_err, parted, n_matches = 0.0, 0, 0
    cases = particle_cases(states, dev)
    for name, args in cases:
        n_p, n_rounds, k = args[5].shape[:3]
        got = kernels.mc_match_batched(*args)
        twin, margins = twin_record(args)
        torch.cuda.synchronize()
        check(got[0].shape == (n_p, 3) and got[1].shape == (n_p,) and got[2].shape == (n_p, n_rounds),
              f"mc_match_batched output malformed ({name})")
        held_to_singles(name, got, args)
        errs = [against_twin(f"{name}, particle {m}", [t[m] for t in got], [t[m] for t in twin],
                             margins[m]) for m in range(n_p)]
        err = max(e for e, _ in errs)
        parted += sum(a for _, a in errs)
        n_matches += n_p
        max_err = max(max_err, err)
        print(f"mc_match_batched [{name}]: P={n_p} K={k} rounds={n_rounds} R'={args[1].shape[1]} "
              f"{args[0].shape[1]}x{args[0].shape[2]} equal to {n_p} single launches and to "
              f"mc_match_rounds bit for bit; vs plain twin max|diff|={err:.3e} (tol {TOL:g})",
              flush=True)
    no_beam = dict(cases)["particle 3 without a valid beam"]
    check(not bool(kernels.mc_match_batched(*no_beam)[2][3].any()),
          "a particle with no valid beam must score 0")
    print(f"particle match: {n_in_place} matches in place equal to the cut-out windows; "
          f"{len(cases)} cases, {n_matches} matches of mc_match_batched equal to single launches "
          f"bit for bit; {parted} part from the plain twin after a round decided by less than "
          f"{KNIFE_EDGE:g}", flush=True)

    cut = cut_out(s)
    # in turns: windows cut out and matched, in place, in place, cut out and matched
    ms, cut_path_ms, chained = time_pair(lambda: kernels.mc_match_windows(*s),
                                         lambda: kernels.mc_match_batched(*cut_out(s)))
    cut_ms, cut_plain_ms, cut_chained = time_pair(lambda: kernels.mc_match_batched(*cut),
                                                  lambda: kernels.mc_match_ref(*cut), plain_calls=10)
    plain_ms = statistics.median(time_ms(lambda: kernels.mc_match_windows_ref(*s), 20))
    singles_ms = statistics.median(time_ms(lambda: singles_of(kernels.mc_match, cut), 20))
    n_p, n_rounds, k = s[10].shape[:3]
    sh, sw = s[4:6]
    # every input read once: of each window the distinct cells the taps of
    # every scored pose read (occupancy and mask in place, the cut-out
    # plane's float cut out), its corner, the weighted beams' points, every
    # weight, origin, prior and noise; poses, probs and traces written once;
    # the operations of the beams that carry weight
    cells, _ = tap_cells_maps(cut[0], visited_poses(kernels.mc_match_loop,
                                                    kernels.overlap_score_batched, cut),
                              cut[1], cut[2], cut[3], cut[6])
    n_w = int((s[7] != 0).sum())
    scan_bytes = 4 * (2 * n_w + sum(a.numel() for a in s[7:11]) + n_p * (3 + 1 + n_rounds))
    n_bytes = cells * (4 + 1) + 8 * 2 * n_p + scan_bytes
    cut_bytes = 4 * cells + scan_bytes
    n_ops = OVERLAP_OPS_PER_POINT * (1 + n_rounds * k) * n_w
    b_ms, by = bound_ms(n_bytes, n_ops)
    cut_b_ms, cut_by = bound_ms(cut_bytes, n_ops)
    print(f"mc_match_windows P={n_p} K={k} rounds={n_rounds} R'=180 {sh}x{sw} windows read in place: "
          f"kernel {ms:.4f} ms, plain (cut, where, mc_match_ref) {plain_ms:.4f} ms, the windows cut "
          f"out and matched {cut_path_ms:.4f} ms (medians of 100, 20 and 100 calls in turns, CUDA "
          f"events), kernel {chained:.4f} ms a launch over 200 back to back; bound {b_ms:.6f} "
          f"ms by {by} ({n_bytes} B: {cells} tap cells of {n_p * sh * sw}; {n_ops} operations). "
          f"mc_match_batched on the cut-out windows: "
          f"{cut_ms:.4f} ms, plain {cut_plain_ms:.4f} ms, {cut_chained:.4f} ms chained, bound "
          f"{cut_b_ms:.6f} ms by {cut_by} ({cut_bytes} B); {n_p} single-plane mc_match launches "
          f"{singles_ms:.4f} ms (median of 20); no single PyTorch call computes it", flush=True)
    return {
        "name": "mc_match_batched", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/mc_match.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "cases_bitwise_equal_to_single_launches": len(cases),
        "matches_in_place_equal_to_cut_out": n_in_place, "matches_parted_from_twin": parted,
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "cut_out_path_ms": cut_path_ms,
        "cut_out_ms": cut_ms, "cut_out_chained_ms": cut_chained, "cut_out_bound_ms": cut_b_ms,
        "single_launches_ms": singles_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def gmapping_bits(e):
    """The RBPF's genealogy, weights and maps, for comparing two runs."""
    return [*e.genealogy, e.state.log_weights, e.state.gm.cells, e.state.poses]


def phase_gmapping_path(cfg, scans, odom, gt, odo_ate, smi):
    """The timed RBPF run with the counts at 0 before and read after, its
    checks, and once more for repeatability; returns the launch counts."""
    from slam_constructor_tpu_torch.models import gmapping
    from slam_constructor_tpu_torch.ops import scoring
    from slam_constructor_tpu_torch.utils import evaluate

    # the match reads the windows in place: nothing cuts one out
    cuts, views = (recorder(scoring.WindowView.cut), recorder(scoring.window_view))
    with handed_in(cuts[0], "cut", scoring.WindowView), handed_in(views[0], "window_view", scoring):
        reset_launches()
        e, traj, neffs, secs = run_gmapping_path(cfg, scans, odom, gt, "error")
        launches = read_launches()
    want = expect(mc_match_batched=N_SCANS, scan_insert=N_SCANS, prng_draws=N_SCANS)
    resamples = int((e.genealogy[1] != torch.arange(cfg.n_particles, device=traj.device)).any(1).sum())
    print(f"gmapping main path ({cfg.n_particles} particles): {N_SCANS} scans in {secs:.3f} s = "
          f"{N_SCANS / secs:.1f} scans/s on {smi}, with the sync check on, no host sync; "
          f"{resamples} resamplings, min Neff {float(neffs.min()):.2f}; launches {launches} "
          f"(expected {want}); windows cut out for the match: {len(cuts[1]) + len(views[1])}",
          flush=True)
    check(launches == want, f"gmapping: launches {launches}, expected {want}")
    LIBM_BY_PATH["gmapping"] = dict(LAST_LIBM)
    check_libm("gmapping", expect_libm("gmapping"))
    check(not cuts[1] and not views[1], "gmapping: the match windows were cut out, not read in place")
    winner = e.winner_trajectory()
    check(winner.shape == (N_SCANS, 3) and bool(torch.isfinite(winner).all())
          and bool(torch.isfinite(traj).all()), "gmapping: non-finite poses")
    check(bool(torch.isfinite(e.occupancy).all()) and e.occupancy.shape == (MAP, MAP),
          "gmapping: the map is malformed")
    ate = float(evaluate.ate(winner, gt, align=False))
    online = float(evaluate.ate(traj, gt, align=False))
    mean = float(evaluate.ate(gmapping.weighted_mean_trajectory(*e.genealogy, e.state.log_weights),
                              gt, align=False))
    limit = max(GMAPPING_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping main path: winner ATE {ate:.4f} m (no alignment; limit: the reference's worst "
          f"key + margin {limit:.4f}; the reference's five keys "
          f"{min(GMAPPING_REFERENCE_ATE_BY_KEY):.4f}-{max(GMAPPING_REFERENCE_ATE_BY_KEY):.4f}), online "
          f"(best particle a scan) {online:.4f} m, weighted mean {mean:.4f} m, odometry only "
          f"{odo_ate:.4f} m (the reference does not beat it on this sequence either)", flush=True)
    check(ate <= limit, f"gmapping: winner ATE {ate} above the reference's worst key + margin")
    e2, traj2, _, secs2 = run_gmapping_path(cfg, scans, odom, gt, 0)
    same = torch.equal(traj2, traj) and all(
        torch.equal(a, b) for a, b in zip(gmapping_bits(e), gmapping_bits(e2)))
    print(f"gmapping repeatability: trajectory, genealogy, log-weights and maps of two runs equal: "
          f"{same}; second run, sync check off: {N_SCANS / secs2:.1f} scans/s", flush=True)
    check(same, "gmapping: two runs differ")
    return launches


def phase_gmapping_quality(cfg, dev):
    """The gmapping path over the reference's quality sequence (two laps):
    the winner's ATE below odometry's and within the reference's worst of
    five keys + margin on the same sequence."""
    from slam_constructor_tpu_torch.utils import evaluate

    scans, odom, gt = gmapping_quality_sequence(dev)
    e, traj, _, secs = run_gmapping_path(cfg, scans, odom, gt, 0)
    ate = float(evaluate.ate(e.winner_trajectory(), gt, align=False))
    odo = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    limit = max(GMAPPING_2LAP_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping, the reference's quality sequence ({len(gt)} scans, two laps): winner ATE "
          f"{ate:.4f} m (limits: odometry {odo:.4f}, the reference's worst key + margin "
          f"{limit:.4f}), online {float(evaluate.ate(traj, gt, align=False)):.4f} m; "
          f"{len(gt) / secs:.1f} scans/s", flush=True)
    check(ate < odo, f"gmapping 2 laps: winner ATE {ate} not below odometry's {odo}")
    check(ate <= limit, f"gmapping 2 laps: winner ATE {ate} above the reference's worst key + margin")


def phase_gmapping_improved(dev, scans, odom, gt):
    """64 scans of the gmapping path with the improved proposal and the
    minimumScore gate on: `overlap_score_batched` at M = 30 scores the
    probes (K = 16) and the gate (K = 1) every scan; every 8th launch of
    each is held to its twin and to 30 single-plane launches. Returns the
    launch counts and the batched kernel's times at the probes' shape."""
    import warnings

    from slam_constructor_tpu_torch.ops import kernels

    n = GM_IMPROVED_SCANS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the preset's note on the improved proposal
        cfg = dataclasses.replace(gmapping_config(proposal="improved"),
                                  min_match_prob=GM_IMPROVED_GATE)
    match_probs, match = [], kernels.mc_match_batched

    def matched(*args):
        out = match(*args)
        match_probs.append(out[1])
        return out

    batched, kept = recorder(kernels.overlap_score_batched)
    with handed_in(batched, "overlap_score_batched"), handed_in(matched, "mc_match_batched"):
        reset_launches()
        _, traj, _, secs = run_gmapping_path(cfg, scans[:n], odom[:n], gt, "error")
        launches = read_launches()
    want = expect(overlap_score_batched=2 * n, mc_match_batched=n, scan_insert=n, prng_draws=n)
    print(f"gmapping, improved proposal and gate {GM_IMPROVED_GATE}, {n} scans: {n / secs:.1f} "
          f"scans/s with the sync check on; launches {launches} (expected {want})", flush=True)
    check(launches == want, f"gmapping improved: launches {launches}, expected {want}")
    check_libm("gmapping improved", expect_libm("gmapping improved", n))
    check(bool(torch.isfinite(traj).all()), "gmapping improved: non-finite poses")
    probes = [a for a in kept if a[1].shape[1] == cfg.proposal_samples]
    gates = [a for a in kept if a[1].shape[1] == 1]
    check(len(probes) == n and len(gates) == n, "the improved path scored no probes or no gate")
    turned = float((torch.stack(match_probs) < GM_IMPROVED_GATE).float().mean())
    print(f"the gate turned back {turned:.3f} of the particles' matches", flush=True)
    max_err = 0.0
    for name, group in (("probes K=16", probes), ("gate K=1", gates)):
        for a in group[::8]:
            got = kernels.overlap_score_batched(*a)
            want_t = kernels.overlap_score_ref(*a)
            singles = torch.stack([kernels.overlap_score(*(t[m].contiguous() for t in a[:5]), *a[5:])
                                   for m in range(a[0].shape[0])])
            torch.cuda.synchronize()
            err = float((got - want_t).abs().max())
            check(err <= TOL, f"overlap_score_batched disagrees with its twin ({name}): {err}")
            check(torch.equal(bits(got), bits(singles)),
                  f"overlap_score_batched differs from single-plane launches ({name})")
            max_err = max(max_err, err)
        a = group[0]
        print(f"overlap_score_batched on the improved path [{name}]: M={a[0].shape[0]} "
              f"K={a[1].shape[1]} R'={a[2].shape[1]} {a[0].shape[1]}x{a[0].shape[2]}, "
              f"{len(group[::8])} launches: max|diff| to the twin {max_err:.3e} (tol {TOL:g}); equal "
              f"to {a[0].shape[0]} single-plane launches bit for bit", flush=True)
    times = {}
    for name, a in (("probes", probes[-1]), ("gate", gates[-1])):
        ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_batched(*a),
                                          lambda: kernels.overlap_score_ref(*a))
        n_m, k = a[1].shape[:2]
        n_bytes, n_ops, cells = batched_score_work(a)
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"overlap_score_batched M={n_m} K={k} R'=180 160^2 (the {name}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, kernel {chained:.4f} ms a launch over 200 back to back; "
              f"bound {b_ms:.6f} ms by {by} ({n_bytes} B: {cells} tap cells; {n_ops} operations)",
              flush=True)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "bound_ms": b_ms,
                       "bound_by": by}
    return launches, {**times, "max_abs_err": max_err}


def phase_gmapping_card_vs_cpu(dev, scans, odom, gt, n=16, make=None, name="gmapping"):
    """The first ``n`` scans of the gmapping path (or of the engines that
    ``make`` builds) on the card and on the CPU with the same draws (made
    with numpy)."""
    from slam_constructor_tpu_torch.models import gmapping

    cfg = make(device="cpu").cfg if make else gmapping_config()
    mc, p = cfg.matcher_cfg, cfg.n_particles
    rng = np.random.default_rng(5)

    def normals(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    draws = gmapping.Draws(proposal=normals(n, p, 3), match=normals(n, p, mc.rounds, mc.batch, 3),
                           u0=torch.from_numpy(rng.uniform(0, 1 / p, n).astype(np.float32)))
    runs = []
    for d in (None, "cpu"):
        on = torch.device(d) if d else dev
        e, _, _, _ = run_gmapping_path(cfg, scans[:n].to(on), odom[:n].to(on), gt.to(on), 0,
                                       draws=draws, device=d, make=make)
        runs.append([t.cpu() for t in gmapping_bits(e)])
    (pa, aa, la, ca, _), (pb, ab, lb, cb, _) = runs
    diff = float((pa - pb).abs().max())
    # a free sample on a cell's border may fall to either side (sin and cos
    # round differently): that cell's count then differs by one for good
    moved = ca[..., -1] != cb[..., -1]
    belief = float((ca[..., :-1] - cb[..., :-1]).abs().amax(-1)[~moved].max())
    print(f"{name} card vs CPU, {n} scans, the same draws: max|pose diff| {diff:.3e} (tol 1e-4), "
          f"ancestors equal: {torch.equal(aa, ab)}, max|log-weight diff| "
          f"{float((la - lb).abs().max()):.3e} (tol 1e-4); {int(moved.sum())} of {moved.numel()} "
          f"cells counted one sample more or less (at most {GM_MOVED_CELLS}), max|belief diff| "
          f"elsewhere {belief:.3e} (tol 1e-5)", flush=True)
    check(diff <= 1e-4 and torch.equal(aa, ab), f"{name} card vs CPU: trajectories disagree")
    check(float((la - lb).abs().max()) <= 1e-4, f"{name} card vs CPU: weights disagree")
    check(int(moved.sum()) <= GM_MOVED_CELLS and belief <= 1e-5, f"{name} card vs CPU: maps disagree")


# --- M3RSM: the pyramid (K4a), the level score (K4b) and their paths ---------


def snapshot(search):
    """A copy of an ``M3RSMSearch``'s tensors, the pyramid packed into one
    buffer as the kernels lay it out, so that later steps cannot change
    what was kept."""
    buf = torch.cat([p.reshape(-1) for p in search.planes])
    planes = tuple(v.view(p.shape) for v, p in zip(
        buf.split([p.numel() for p in search.planes]), search.planes))
    tensors = {f.name: getattr(search, f.name).clone() for f in dataclasses.fields(search)
               if isinstance(getattr(search, f.name), torch.Tensor)}
    return dataclasses.replace(search, planes=planes, **tensors)


def search_recorder(keep=lambda n: True):
    """``kernels.m3rsm_search`` with a snapshot of the arguments of every
    call ``n`` for which ``keep(n)`` holds: returns the stand-in and the list
    it fills."""
    from slam_constructor_tpu_torch.ops import kernels

    fn, kept, n = kernels.m3rsm_search, [], [0]

    def recording(search):
        if keep(n[0]):
            kept.append(snapshot(search))
        n[0] += 1
        return fn(search)

    return recording, kept


def capture_m3rsm_searches(cfg, scans, odom, gt, every=32):
    """A run of the viny_m3rsm path (it also warms the path up) that keeps
    the arguments of the match of every ``every``-th scan; returns them and
    the run's engine."""
    recording, kept = search_recorder(lambda n: n % every == 0)
    with handed_in(recording, "m3rsm_search"):
        _, _, _, e = run_main_path(cfg, scans, odom, gt, 0)
    return kept, e


def level_launches_of(searches):
    """The arguments of the level-score launches of ``m3rsm_search_levels``
    on each kept match, in order (levels + 1 a match)."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.m3rsm_score_level)
    with handed_in(recording, "m3rsm_score_level"):
        for search in searches:
            kernels.m3rsm_search_levels(search)
    return kept


def capture_full_m3rsm(cfg, scans, odom, gt):
    """A run of the full path with the M3RSM loop matcher (it also warms the
    path up) that keeps the arguments of every pyramid build of the submaps
    and of every loop match."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, builds = recorder(kernels.m3rsm_pyramid)
    searching, matches = search_recorder()
    with handed_in(recording, "m3rsm_pyramid"), handed_in(searching, "m3rsm_search"):
        run_full_path(cfg, scans, odom, gt, 0)
    return builds, matches


def graph_ms(fn, n: int = 50, replays: int = 5) -> float:
    """ms a call with ``n`` calls of ``fn`` captured into one CUDA graph and
    replayed (the median over ``replays``): the device's time a launch with
    the gap between two launches, and no host in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up where the capture will run
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def pyramid_bytes(n_cells: int, stored: int, read_per_cell: int = 5) -> int:
    """Bytes a pyramid build or refresh must move: the occupancy (4 B) and
    the mask (1 B) of each level-0 cell read once, every level's cells
    (``stored``, f32) written once."""
    return read_per_cell * n_cells + 4 * stored


def pyramid_ops(n_cells: int, stored: int) -> int:
    """f32 operations of a pyramid: the where of a level-0 cell, three
    maxes a coarser cell."""
    return n_cells + 3 * (stored - n_cells)


def phase_m3rsm_pyramid_kernel(dev, gm, model, kept_builds):
    """K4a against its plain twin, bit for bit: the main path's 256^2 map at
    4 levels, the loop closer's kept submap builds (M up to 32 of 120^2 at 3
    levels), the occupancy as a channel of the cells, an unaligned 100 x 90
    map at 5 levels; the 144^2 refresh clamped at every corner and edge and
    in the middle, and a gate at 0 that leaves the planes untouched. Then
    timed. Returns the `kernels` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels, scoring

    g = torch.Generator(device=dev).manual_seed(11)
    view = scoring.MapView.of(gm, model)
    occ, known = view.occ.contiguous(), view.known.contiguous()
    check(kept_builds, "the loop closer built no submap pyramid")
    widest = max(kept_builds, key=lambda a: a[0].shape[0])
    check(tuple(widest[0].shape) == (32, 120, 120) and widest[2] == 3,
          f"the widest submap build is {tuple(widest[0].shape)} at {widest[2]} levels")
    rand_occ = torch.rand((100, 90), generator=g, device=dev)
    rand_known = torch.rand((100, 90), generator=g, device=dev) < 0.7
    cells = torch.stack([occ, torch.zeros_like(occ)], dim=-1)
    builds = [("main path map 256^2, 4 levels", (occ, known, 4, 0.5)),
              ("the occupancy a channel of the cells", (cells[..., 0], known, 4, 0.5)),
              ("unaligned 100 x 90, 5 levels", (rand_occ, rand_known, 5, 0.5)),
              ("3 levels on a 256^2 map", (occ, known, 3, 0.5))]
    builds += [(f"loop closer's submaps, M={a[0].shape[0]}", a) for a in kept_builds[::4]]
    for name, a in builds:
        got = kernels.m3rsm_pyramid(*a)
        want = kernels.m3rsm_pyramid_ref(*a)
        torch.cuda.synchronize()
        same = len(got) == len(want) and all(torch.equal(bits(x), bits(y))
                                             for x, y in zip(got, want))
        print(f"m3rsm_pyramid build [{name}]: {tuple(a[0].shape)} {a[2]} levels, equal to the "
              f"plain twin bit for bit: {same}", flush=True)
        check(same, f"m3rsm_pyramid differs from its twin ({name})")
    planes = kernels.m3rsm_pyramid(occ, known, 4, 0.5)
    edited = torch.where(torch.rand(occ.shape, generator=g, device=dev) < 0.3, 0.97, occ)
    size, top = 144, MAP - 1
    centres = [(128, 128), (0, 0), (0, top), (top, 0), (top, top), (0, 128), (top, 128),
               (128, 0), (128, top)]
    kept = [p.clone() for p in planes]
    for c in centres:
        center = torch.tensor(c, device=dev)
        for gate in (1.0, 0.0):
            gate_t = torch.full((), gate, device=dev)
            got = kernels.m3rsm_pyramid_update(planes, edited, known, center, size, 0.5, gate_t)
            want = kernels.m3rsm_pyramid_update_ref(planes, edited, known, center, size, 0.5,
                                                    gate_t)
            torch.cuda.synchronize()
            ok = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want))
            if gate == 0.0:
                ok = ok and all(torch.equal(bits(x), bits(y)) for x, y in zip(got, planes))
            check(ok, f"m3rsm_pyramid update at {c}, gate {gate}: differs from its twin")
            check(all(torch.equal(bits(x), bits(y)) for x, y in zip(planes, kept)),
                  f"m3rsm_pyramid update at {c}, gate {gate}: wrote into the planes handed in")
    print(f"m3rsm_pyramid update: a {size}^2 region of the 256^2 map at {len(centres)} centres "
          f"(every corner and edge, the middle) into new planes equal to the twin bit for bit; a "
          f"gate at 0 copied the planes; the planes handed in untouched", flush=True)

    center, gate_t = torch.tensor((128, 128), device=dev), torch.ones((), device=dev)
    stored0 = sum(p.numel() for p in planes)
    region = sum((size >> lvl) ** 2 for lvl in range(5))
    sub = widest[0].shape[0] * sum(((120 + (1 << lvl) - 1) >> lvl) ** 2 for lvl in range(4))
    shapes = {
        "build_256": ((lambda: kernels.m3rsm_pyramid(occ, known, 4, 0.5)),
                      (lambda: kernels.m3rsm_pyramid_ref(occ, known, 4, 0.5)),
                      occ.numel(), stored0),
        "update_144": ((lambda: kernels.m3rsm_pyramid_update(planes, edited, known, center,
                                                             size, 0.5, gate_t)),
                       (lambda: kernels.m3rsm_pyramid_update_ref(planes, edited, known, center,
                                                                 size, 0.5, gate_t)),
                       size * size, region),
        "build_32x120": ((lambda: kernels.m3rsm_pyramid(*widest)),
                         (lambda: kernels.m3rsm_pyramid_ref(*widest)),
                         widest[0].numel(), sub),
    }
    plane0 = torch.where(known, occ, 0.5)[None, None]

    def pooled():  # the yardstick: max_pool2d, which pads nothing, on an even map
        p = plane0
        for _ in range(4):
            p = torch.nn.functional.max_pool2d(p, 2)
        return p

    for _ in range(20):
        pooled()
    library_ms = statistics.median(time_ms(pooled, 100))
    library_device_ms = graph_ms(pooled)
    out = {}
    for name, (kernel, plain, n_cells, stored) in shapes.items():
        ms, plain_ms, chained = time_pair(kernel, plain, plain_calls=20)
        device = graph_ms(kernel)
        n_bytes = pyramid_bytes(n_cells, stored)
        if name == "update_144":  # new planes: the region pooled, the rest copied
            n_bytes = pyramid_bytes(n_cells, stored0) + 4 * (stored0 - region)
        b_ms, by = bound_ms(n_bytes, pyramid_ops(n_cells, stored))
        print(f"m3rsm_pyramid {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (medians, CUDA "
              f"events), kernel {chained:.4f} ms a launch over 200 back to back, {device:.4f} ms "
              f"a launch replayed from a CUDA graph; bound {b_ms:.6f} ms by {by} ({n_bytes} B)",
              flush=True)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device,
                     "bound_ms": b_ms, "bound_by": by}
    print(f"four chained torch.nn.functional.max_pool2d calls on the even 256^2 plane (the "
          f"yardstick, not the port): {library_ms:.4f} ms a call, {library_device_ms:.4f} ms "
          f"replayed from a CUDA graph", flush=True)
    return {
        "name": "m3rsm_pyramid", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/m3rsm_pyramid.cu",
        "replaces": "slam_constructor_tpu/ops/m3rsm.py:102",
        "max_abs_err": 0.0, **out["update_144"], "by_shape": out,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "library_call": "4 chained torch.nn.functional.max_pool2d on the even 256^2 plane",
    }


#: f32 and integer operations of a (rect, beam) pair of `m3rsm_score_level`:
#: the cell 2, a corner 2 adds, 2 shifts, 4 compares and a max, the sums 3
def level_ops(level: int) -> int:
    return 2 + (4 if level else 1) * 9 + 3


def phase_m3rsm_level_kernel(dev, kept):
    """K4b against its plain twin (2e-6) on the arguments of every 32nd
    scan of the viny_m3rsm path at all five levels, and at edge cases: the
    window at the map's first and far corner, rects off the window, a mask
    of zeros; then timed at each level of a scan. Returns the `kernels`
    entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    levels = sorted({a[2] for a in kept})
    check(levels == [0, 1, 2, 3, 4], f"the path scored levels {levels}")
    per_scan = len(levels)
    cases = [(f"scan {32 * (i // per_scan)} level {a[2]}", a) for i, a in enumerate(kept)]
    scan_args = {a[2]: a for a in kept[8 * per_scan:9 * per_scan]}  # scan 256's five
    for lvl, a in scan_args.items():
        plane, corner, _, wh, ww, c0, cands, mask, unknown = a
        side = (wh << lvl)
        far = torch.full_like(corner, MAP - side)

        def edited(i, t, a=a):
            return a[:i] + (t,) + a[i + 1:]

        off = cands + torch.tensor([0, 64, -64], dtype=torch.int32, device=dev)
        mixed = cands + (torch.arange(cands.shape[1], device=dev) % 2 == 0)[None, :, None].int() * \
            torch.tensor([0, 200, 0], dtype=torch.int32, device=dev)
        cases += [(f"level {lvl}: the window at the map's first corner",
                   edited(1, torch.zeros_like(corner))),
                  (f"level {lvl}: the window at the map's far corner", edited(1, far)),
                  (f"level {lvl}: rects off the window", edited(6, off.contiguous())),
                  (f"level {lvl}: every other rect far off the window",
                   edited(6, mixed.contiguous())),
                  (f"level {lvl}: a mask of zeros", edited(7, torch.zeros_like(mask)))]
    max_err = 0.0
    for name, a in cases:
        got = kernels.m3rsm_score_level(*a)
        want = kernels.m3rsm_score_level_ref(*a)
        again = kernels.m3rsm_score_level(*a)
        torch.cuda.synchronize()
        check(got.shape == a[6].shape[:2] and bool(torch.isfinite(got).all()),
              f"m3rsm_score_level output malformed ({name})")
        err = float((got - want).abs().max())
        check(err <= TOL, f"m3rsm_score_level disagrees with its twin ({name}): {err}")
        check(torch.equal(bits(got), bits(again)), f"m3rsm_score_level not repeatable ({name})")
        if "zeros" in name:
            check(not bool(got.any()), "a mask of zeros must score 0")
        max_err = max(max_err, err)
    print(f"m3rsm_score_level: {len(cases)} cases ({len(kept)} kept from the path, every 32nd "
          f"scan at all five levels) within {max_err:.3e} of the plain twin (tol {TOL:g}), "
          f"repeatable bit for bit", flush=True)
    by_level, sums = {}, {"ms": 0.0, "plain_ms": 0.0, "chained_ms": 0.0, "bound_ms": 0.0}
    n_bytes_all = n_ops_all = 0
    for lvl in levels:
        a = scan_args[lvl]
        plane, corner, _, wh, ww, c0, cands, mask, _ = a
        ms, plain_ms, chained = time_pair(lambda: kernels.m3rsm_score_level(*a),
                                          lambda: kernels.m3rsm_score_level_ref(*a))
        k, r = cands.shape[1], mask.shape[1]
        # the window's cells, the endpoint cells, the rects, the mask and
        # the corner read once, the scores written once
        n_bytes = 4 * (wh * ww + c0.numel() + cands.numel() + mask.numel() + 2 + k)
        n_ops = k * r * level_ops(lvl)
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"m3rsm_score_level level {lvl} K={k} R={r} window {wh}x{ww}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (median of 100 calls each, CUDA events), kernel "
              f"{chained:.4f} ms a launch over 200 back to back; bound {b_ms:.6f} ms by {by} "
              f"({n_bytes} B, {n_ops} operations); no single PyTorch call computes it", flush=True)
        by_level[lvl] = {"k": k, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
                         "bound_ms": b_ms, "bound_by": by}
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("chained_ms", chained),
                       ("bound_ms", b_ms)):
            sums[key] += v
        n_bytes_all += n_bytes
        n_ops_all += n_ops
    return {
        "name": "m3rsm_level", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/m3rsm_level.cu",
        "replaces": "slam_constructor_tpu/ops/m3rsm.py:160",
        "max_abs_err": max_err, **sums, "bound_by": bound_ms(n_bytes_all, n_ops_all)[1],
        "shape": "a scan's five launches, levels 4 to 0", "by_level": by_level,
        "library_ms": None,
    }


def search_work(search):
    """(bytes, operations) an ``m3rsm_search`` call needs: every level's
    window (each request's, at most the maps' whole pyramids), the refine
    window's occupancy and mask, the endpoints, weights, rects and priors
    read once, the results written once; the endpoint cells of every theta,
    a level's (rect, beam) pairs for the beams that carry weight, a sort's
    K log2 K comparisons of a level that selects, and the hill climb's poses
    x weighted beams."""
    from slam_constructor_tpu_torch.ops import kernels

    levels = len(search.planes) - 1
    n_b = search.prior.shape[0]
    wh, ww = (search.window,) * 2 if search.window else tuple(search.occ.shape[-2:])
    window = n_b * sum(-(-wh // (1 << lvl)) * -(-ww // (1 << lvl)) for lvl in range(levels + 1))
    window = min(window, sum(p.numel() for p in search.planes))
    refine = min(n_b * wh * ww, search.occ.numel()) if search.iterations else 0
    small = (search.origin, search.pts, search.mask, search.top, search.thetas, search.prior)
    n_bytes = (4 * window + 5 * refine + 4 * sum(t.numel() for t in small)
               + 4 * n_b * (4 + search.iterations))
    ks = kernels.m3rsm_frontiers(search.top.shape[0], search.beam_width, levels)
    beams = int((search.mask != 0).sum())  # over the requests
    n_ops = n_b * search.thetas.shape[0] * search.mask.shape[1] * 12  # the endpoint cells
    n_ops += sum(k * beams * level_ops(levels - i) for i, k in enumerate(ks))
    n_ops += n_b * sum(int(k * math.log2(max(k, 2))) for k in ks[:-1])
    climbed = int((search.mask[:, ::search.stride] != 0).sum())
    n_ops += (1 + 6 * search.iterations) * climbed * OVERLAP_OPS_PER_POINT
    return n_bytes, n_ops


def m3rsm_search_cases(dev, path_searches, loop_searches, cfg, e, scans, gt):
    """(name, M3RSMSearch) of phase 22: the kept matches of the viny_m3rsm
    path and of the loop closer (every 4th), and edge cases on the path's
    final map."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import kernels, m3rsm, scoring
    from slam_constructor_tpu_torch.ops.scan import LaserScan
    from slam_constructor_tpu_torch.utils import datagen

    cases = [(f"viny_m3rsm scan {32 * i}", a) for i, a in enumerate(path_searches)]
    cases += [(f"full_m3rsm loop match {4 * i}, M={a.prior.shape[0]}", a)
              for i, a in enumerate(loop_searches[::4])]
    view = scoring.MapView.of(e.state.gm, cfg.cell_model)
    idx = list(range(0, N_SCANS, 64))
    priors = gt[idx] + torch.tensor([0.1, -0.05, 0.03], device=dev)
    batch = LaserScan(scans.ranges[idx], scans.bearings[idx], scans.valid[idx])
    pws = torch.stack([engine._point_weights(cfg, scans[i]) for i in idx])
    recording, kept = search_recorder()
    mc = cfg.matcher_cfg
    # M3RSMConfig's defaults (the whole map, 5 levels, 17 thetas, K up to
    # 1,024) with the path's scan and with a scan of 1,081 beams
    defaults = m3rsm.M3RSMConfig(scoring=scoring.ScoringConfig(reducer="overlap"))
    occ, origin, scale = datagen.cecum_world(device=dev)
    wide, _, _ = datagen.synth_sequence(occ, origin, scale, gt[idx[4]][None],
                                        datagen.default_bearings(1081, device=dev), rng=0)
    with handed_in(recording, "m3rsm_search"):
        m3rsm.m3rsm_match_many(view, batch, priors, mc, pws)
        m3rsm.m3rsm_match(view, scans[idx[4]], priors[4], None, dataclasses.replace(mc, window=0),
                          pws[4])
        m3rsm.m3rsm_match(view, scans[idx[4]], priors[4], None, defaults, pws[4])
        m3rsm.m3rsm_match(view, wide[0], priors[4], None, defaults, None)
    cases += [("8 requests on one map", kept[0]), ("window 0 (the whole 256^2 map)", kept[1]),
              ("M3RSMConfig's defaults", kept[2]),
              ("M3RSMConfig's defaults, 1081 beams", kept[3])]
    mid = path_searches[8]  # scan 256
    cases.append(("scan 256, refine 0", dataclasses.replace(mid, iterations=0)))
    unknown = torch.zeros_like(mid.known)
    planes = kernels.m3rsm_pyramid(mid.occ, unknown, len(mid.planes) - 1, mid.unknown)
    cases.append(("scan 256 on an all-unknown map",
                  dataclasses.replace(mid, planes=planes, known=unknown)))
    return cases


def twin_scores(search, pose):
    """The plain twin's score of each request's ``pose`` f32[B, 3] on its
    refine window (the hill climb's score)."""
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops import kernels

    n_b = search.prior.shape[0]
    corner, (wh, ww), origin, _ = kernels.m3rsm_window_cells(search)
    occ = search.occ if search.occ.dim() == 3 else search.occ[None]
    known = search.known if search.known.dim() == 3 else search.known[None]
    occ, known = occ.expand(n_b, -1, -1), known.expand(n_b, -1, -1)
    row, col = corner[:, 0].long(), corner[:, 1].long()
    plane = torch.where(gridlib.take_window(known, row, col, wh, ww),
                        gridlib.take_window(occ, row, col, wh, ww), search.unknown)
    return kernels.overlap_score_ref(
        plane, pose[:, None, :].contiguous(), search.pts[:, ::search.stride].contiguous(),
        search.mask[:, ::search.stride].contiguous(), origin.contiguous(), search.scale,
        search.unknown)[:, 0]


def phase_m3rsm_search_kernel(dev, cases):
    """The whole match in one launch (K4b) against the level launches bit
    for bit and against its plain twin, then timed. Returns the `kernels`
    entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    max_err, parted = 0.0, []
    for name, a in cases:
        got = kernels.m3rsm_search(a)
        levels = kernels.m3rsm_search_levels(a)
        again = kernels.m3rsm_search(a)
        twin = kernels.m3rsm_search_ref(a)
        torch.cuda.synchronize()
        n_b = a.prior.shape[0]
        check(got[0].shape == (n_b, 3) and got[2].shape == (n_b, a.iterations)
              and bool(torch.isfinite(got[0]).all()), f"m3rsm_search output malformed ({name})")
        same = all(torch.equal(bits(x), bits(y)) for x, y in zip(got, levels))
        check(same, f"m3rsm_search differs from the level launches ({name})")
        check(all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again)),
              f"m3rsm_search not repeatable ({name})")
        apart = (got[0] != twin[0]).any(-1)
        err = float((got[1] - twin[1]).abs()[~apart].max()) if bool((~apart).any()) else 0.0
        check(err <= TOL, f"m3rsm_search prob differs from its twin ({name}): {err}")
        if bool(apart.any()):
            # the two winners, each scored by the twin
            if a.iterations:
                gap = (twin_scores(a, got[0]) - twin[1]).abs()[apart]
            else:
                gap = (got[1] - twin[1]).abs()[apart]
            gap = float(gap.max())
            parted.append(f"{name} ({int(apart.sum())} of {n_b}, winners' scores {gap:.2e} apart)")
            check(gap <= TOL, f"m3rsm_search and its twin pick winners {gap} apart ({name})")
        max_err = max(max_err, err)
    print(f"m3rsm_search: {len(cases)} cases equal to the level launches bit for bit (pose, prob, "
          f"trace) and repeatable; prob within {max_err:.3e} of the plain twin where the poses "
          f"agree (tol {TOL:g}); other winners than the twin's: {parted or 'none'}", flush=True)

    out = {}
    timed = {"viny_m3rsm scan 256": cases[8][1],
             "full_m3rsm widest loop match": max((a for n, a in cases if n.startswith("full")),
                                                 key=lambda a: a.prior.shape[0])}
    for shape, a in timed.items():
        ms, plain_ms, chained = time_pair(lambda a=a: kernels.m3rsm_search(a),
                                          lambda a=a: kernels.m3rsm_search_ref(a), plain_calls=10)
        levels_ms = statistics.median(time_ms(lambda a=a: kernels.m3rsm_search_levels(a), 50))
        device = graph_ms(lambda a=a: kernels.m3rsm_search(a))
        n_bytes, n_ops = search_work(a)
        b_ms, by = bound_ms(n_bytes, n_ops)
        ks = kernels.m3rsm_frontiers(a.top.shape[0], a.beam_width, len(a.planes) - 1)
        print(f"m3rsm_search [{shape}] B={a.prior.shape[0]} K={ks} R={a.mask.shape[1]} "
              f"stride {a.stride}, {a.iterations} rounds: kernel {ms:.4f} ms a call, "
              f"{chained:.4f} ms chained, {device:.4f} ms replayed from a CUDA graph; the level "
              f"launches {levels_ms:.4f} ms a call; plain twin {plain_ms:.4f} ms; bound "
              f"{b_ms:.6f} ms by {by} ({n_bytes} B, {n_ops} operations); no single PyTorch "
              f"call computes it", flush=True)
        out[shape] = {"ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device,
                      "levels_ms": levels_ms, "bound_ms": b_ms, "bound_by": by}
    return {
        "name": "m3rsm_search", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/m3rsm_match.cu",
        "replaces": "slam_constructor_tpu/ops/m3rsm.py:210",
        "max_abs_err": max_err, **out["viny_m3rsm scan 256"], "by_shape": out,
        "library_ms": None,
    }


def capture_scan_matches(cfg, scans, odom, gt, every=64):
    """A run of a main path that keeps the arguments of every ``every``-th
    single match from the scan (``kernels.mc_match_scan``: the prior's
    compose and the scan's points in its prologue), its own draws (a step
    key) kept as they are."""
    from slam_constructor_tpu_torch.ops import kernels

    kept, n = [], [0]
    real = kernels.mc_match_scan

    def keep(a):
        if isinstance(a, kernels.KeyNoise):
            return kernels.KeyNoise(a.key.clone(), a.rounds, a.batch, a.step)
        return a.clone() if isinstance(a, torch.Tensor) else a

    def recording(*args):
        if n[0] % every == 0:
            kept.append(tuple(keep(a) for a in args))
        n[0] += 1
        return real(*args)

    with handed_in(recording, "mc_match_scan"):
        run_main_path(cfg, scans, odom, gt, 0)
    return kept


def phase_mc_match_scan(dev, scan_states):
    """``mc_match_scan`` (the single match of tiny, viny and full's tracker:
    the prior ``compose(pose, odom)`` and the kept beams' endpoints and
    weights computed in the match's prologue, with libm.cuh's functions)
    against ``mc_match`` handed the prior and the points as the package
    computes them (``kernels.scan_match_args``: a ``libm_pose`` and a
    ``libm_cossin`` launch), bit for bit, next key included, on recorded
    calls of the tiny and viny paths and on handed draws; then the device
    time of both routes (graph replay) on tiny's and viny's states."""
    from slam_constructor_tpu_torch.ops import kernels

    n = 0
    for path, states in scan_states.items():
        for i, a in enumerate(states):
            check(a[8] is not None, f"{path} call {i}: the match was not handed the odometry")
            variants = [("its own draws", a)]
            rounds, batch = a[9].rounds, a[9].batch
            g = torch.Generator(device=dev).manual_seed(i)
            normals = torch.randn((rounds, batch, 3), generator=g, device=dev)
            variants.append(("standard normals", a[:9] + (normals,) + a[10:]))
            variants.append(("no odometry", a[:8] + (None,) + a[9:]))
            for name, v in variants:
                got = kernels.mc_match_scan(*v)
                want = kernels.mc_match(*kernels.scan_match_args(*v))
                check(len(got) == len(want) and all(torch.equal(bits(x), bits(y))
                                                     for x, y in zip(got, want)),
                      f"mc_match_scan differs from mc_match handed its prior and points "
                      f"({path} call {i}, {name})")
                n += 1
    print(f"mc_match_scan: {n} matches (the tiny and viny paths' recorded calls with their own "
          f"draws, standard normals, no odometry) bit for bit with mc_match handed the prior and "
          f"the scan's points", flush=True)
    out = {"scan_form_cases_bitwise": n}
    for path in ("tiny", "viny"):
        a = scan_states[path][len(scan_states[path]) // 2]
        handed = kernels.scan_match_args(*a)
        scan_ms = graph_ms(lambda: kernels.mc_match_scan(*a))
        handed_ms = graph_ms(lambda: kernels.mc_match(*handed))
        print(f"mc_match {path} state, device time (graph replay): from the scan and the "
              f"odometry {scan_ms * 1e3:.2f} us, handed the prior and the points "
              f"{handed_ms * 1e3:.2f} us", flush=True)
        out[f"scan_form_device_ms_{path}"] = scan_ms
        out[f"handed_form_device_ms_{path}"] = handed_ms
    return out


#: float64 and float32 operations of a beam of ``beam_weights``: a pair's
#: endpoint angle (LIBM_OPS' "endpoint_angles"), its bin (3), the weight (3)
BEAM_WEIGHTS_OPS = (38, 44 + 3 + 3)


def phase_beam_weights(dev, scans, smi):
    """``beam_weights`` (csrc/beam_weights.cu: viny's beam weights, a block
    a scan) against its plain version ``scan.point_weights_ref`` on the
    card (``libm.plain_versions()``) and on the CPU, bit for bit, on every
    scan of the bench sequence in one launch and scan by scan; then timed at
    the viny path's shape (one scan of 360 beams): device, a call, chained,
    the plain version, the bound. Returns the ``kernels`` entry without the
    launch count."""
    from slam_constructor_tpu_torch.ops import kernels, libm
    from slam_constructor_tpu_torch.ops import scan as scanlib

    ranges, bearings, valid = scans.ranges, scans.bearings, scans.valid
    got = kernels.beam_weights(ranges, bearings, valid)
    with libm.plain_versions():
        plain = scanlib.point_weights_ref(scanlib.LaserScan(ranges, bearings, valid))
    cpu = kernels.beam_weights(ranges.cpu(), bearings.cpu(), valid.cpu())
    singles = torch.stack([kernels.beam_weights(ranges[i], bearings[i], valid[i])
                           for i in range(0, ranges.shape[0], 16)])
    err = float((got - plain).abs().max())
    check(torch.equal(bits(got), bits(plain)) and torch.equal(bits(got.cpu()), bits(cpu)),
          f"beam_weights differs from its plain version: max|diff| {err}")
    check(torch.equal(bits(singles), bits(got[::16])),
          "beam_weights of one scan differs from the same scan in a batch")
    print(f"beam_weights: {ranges.shape[0]} scans of {ranges.shape[1]} beams in one launch equal "
          f"to the plain version on the card and on the CPU bit for bit (and single scans)",
          flush=True)
    i = ranges.shape[0] // 5  # a scan of the first lap's second side
    r1, b1, v1 = ranges[i].contiguous(), bearings[i].contiguous(), valid[i].contiguous()

    def plain_one():
        with libm.plain_versions():
            return scanlib.point_weights_ref(scanlib.LaserScan(r1, b1, v1))

    ms, plain_ms, chained = time_pair(lambda: kernels.beam_weights(r1, b1, v1), plain_one,
                                      plain_calls=20)
    dev_ms = graph_ms(lambda: kernels.beam_weights(r1, b1, v1))
    r = r1.shape[0]
    n_bytes = r * (4 + 4 + 1) + r * 4
    f64, f32 = BEAM_WEIGHTS_OPS
    t_ops = (r - 1) * f64 / PEAK_F64_FLOP_PER_S + r * f32 / PEAK_F32_FLOP_PER_S
    t = max(n_bytes / PEAK_BYTES_PER_S, t_ops)
    b_ms, by = t * 1e3, "bytes" if n_bytes / PEAK_BYTES_PER_S >= t_ops else "operations"
    print(f"beam_weights ({r} beams, the viny path's shape): device {dev_ms * 1e3:.2f} us (graph "
          f"replay), a call {ms:.4f} ms, chained {chained:.4f} ms; plain version on the card "
          f"{plain_ms:.4f} ms; bound {b_ms:.7f} ms by {by} ({n_bytes} B; {(r - 1) * f64} float64 "
          f"and {r * f32} float32 operations); no single PyTorch call computes the weights "
          f"({smi})", flush=True)
    return {"name": "beam_weights", "route": "cuda",
            "source": "slam_constructor_tpu_torch/csrc/beam_weights.cu",
            "replaces": "slam_constructor_tpu/models/engine.py:171", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": dev_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def phase_particle_keys(dev, states):
    """K5 drawing each particle's numbers from its match key (the RBPF's
    ``gmapping.draw`` gives the keys; ``kernels.KeyNoise`` with a leading
    particle dimension) against K5 handed the same keys' erf_inv draws
    (``ErfInvDraws``, ``prng``'s plain version), bit for bit, in place and
    cut out, on the recorded particle matches of the gmapping path; then
    the device time of both routes at the path's shape."""
    from slam_constructor_tpu_torch.ops import kernels

    n = 0
    for i, a in enumerate(states):
        kn = KEYED_DRAWS.get(id(a[10]))
        check(kn is not None and not kn.step and tuple(kn.key.shape) == (GM_PARTICLES, 2),
              f"gmapping match {i}: the particles did not draw from their match keys")
        keyed = a[:10] + (kn,) + a[11:]
        for name, fn, x, y in (("in place", kernels.mc_match_windows, keyed, a),
                               ("cut out", kernels.mc_match_batched, cut_out(keyed), cut_out(a))):
            got, want = fn(*x), fn(*y)
            check(all(torch.equal(bits(p), bits(q)) for p, q in zip(got, want)),
                  f"K5 drawing from the particles' keys differs from the handed draws "
                  f"(gmapping match {i}, {name})")
            n += 1
    a = states[len(states) // 2]
    keyed = a[:10] + (KEYED_DRAWS[id(a[10])],) + a[11:]
    keyed_ms = graph_ms(lambda: kernels.mc_match_windows(*keyed))
    handed_ms = graph_ms(lambda: kernels.mc_match_windows(*a))
    print(f"K5 from the particles' keys: {n} launches bit for bit with the handed draws; device "
          f"time at the path's shape (graph replay) {keyed_ms * 1e3:.2f} us drawing from the keys, "
          f"{handed_ms * 1e3:.2f} us handed the draws", flush=True)
    return {"keyed_cases_bitwise": n, "keyed_device_ms": keyed_ms, "handed_device_ms": handed_ms}


def phase_score_sites(dev, scans, gt):
    """The score sites on the card against the CPU: every beam's
    probability (a one-beam ``overlap_score`` launch, its score the beam's
    probability bit for bit) against the plain twin's on the CPU
    (``kernels._beam_probs_ref``: ``grid.endpoint_cells``, the reference's
    jitted endpoint arithmetic) at 64 poses around a scan's, at every
    reducer; and whole scores card against CPU."""
    from slam_constructor_tpu_torch.models import engine, tiny
    from slam_constructor_tpu_torch.ops import kernels, raycast, scoring

    cfg = tiny.tiny_config(map_size=MAP)
    gm = engine.init_state(cfg, dev).gm
    for i in range(0, 48, 4):  # a map of the scans at their true poses
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
    view = scoring.MapView.of(gm, cfg.cell_model)
    g = torch.Generator(device=dev).manual_seed(3)
    poses = (gt[48] + torch.randn((64, 3), generator=g, device=dev) * torch.tensor(
        [0.2, 0.2, 0.1], device=dev)).contiguous()
    out = {}
    for red in (kernels.BILINEAR, kernels.Reducer("obstacle"), kernels.Reducer("max", radius=1),
                kernels.Reducer("overlap", radius=1, extent=1.5)):
        prep = scoring.prepare(view, scans[48], scoring.ScoringConfig(reducer="overlap"))
        one = torch.ones_like(prep.beam_w[:1])
        card = torch.stack([kernels.overlap_score(prep.plane, poses, prep.pts[i:i + 1].contiguous(),
                                                  one, prep.origin, prep.scale, prep.unknown, red)
                            for i in range(prep.pts.shape[0])], -1).cpu()
        cpu = kernels._beam_probs_ref(prep.plane.cpu()[None], poses.cpu()[None],
                                      prep.pts.cpu()[None], prep.origin.cpu()[None], prep.scale,
                                      prep.unknown, red)[0]
        same = int((bits(card) == bits(cpu)).sum())
        score_card = kernels.overlap_score(prep.plane, poses, prep.pts, prep.beam_w, prep.origin,
                                           prep.scale, prep.unknown, red).cpu()
        score_cpu = kernels.overlap_score(prep.plane.cpu(), poses.cpu(), prep.pts.cpu(),
                                          prep.beam_w.cpu(), prep.origin.cpu(), prep.scale,
                                          prep.unknown, red)
        diff = float((score_card - score_cpu).abs().max())
        label = (red.kind if red.kind in ("bilinear", "obstacle") else f"{red.kind} r{red.radius}"
                 + (f" e{red.extent:g}" if red.kind == "overlap" else ""))
        print(f"score sites, {label}: {same} of {card.numel()} beam probabilities on the card "
              f"equal to the CPU twin's bit for bit; whole scores card vs CPU max|diff| {diff:.3e} "
              f"(the sums' order)", flush=True)
        check(same == card.numel(), f"score sites ({label}): the card's beams part from the CPU's")
        check(diff <= TOL, f"score sites ({label}): the card's scores part from the CPU's: {diff}")
        out[label] = {"beams_equal": same, "beams": card.numel(), "score_max_diff": diff}
    return out


def phase_m3rsm_path(cfg, scans, odom, gt, odo_ate):
    """The viny_m3rsm main path: the timed run (counts, ATE, no host sync,
    a second run bit for bit) and its live pyramid against a rebuild of the
    map; returns the launch counts and the engine."""
    from slam_constructor_tpu_torch.ops import m3rsm, scoring

    levels = cfg.matcher_cfg.levels
    want = expect(m3rsm_search=N_SCANS, m3rsm_pyramid=N_SCANS + 1, scan_insert=N_SCANS,
                  prng_draws=N_SCANS, beam_weights=N_SCANS)
    launches, traj, e = phase_main_path("viny_m3rsm", cfg, want, scans, odom, gt, odo_ate,
                                        VINY_M3RSM_REFERENCE_ATE + VINY_ATE_MARGIN,
                                        expect_libm("viny_m3rsm"))
    rebuilt = m3rsm.build_pyramid(scoring.MapView.of(e.state.gm, cfg.cell_model), levels,
                                  cfg.matcher_cfg.scoring.unknown_prob)
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip(e.state.pyramid, rebuilt))
    print(f"viny_m3rsm: the live pyramid after {N_SCANS} refreshes equal to a rebuild of the map "
          f"bit for bit: {same}", flush=True)
    check(same, "viny_m3rsm: the live pyramid differs from a rebuild")
    return launches, traj, e


def phase_m3rsm_levels_path(cfg, scans, odom, gt, traj):
    """The viny_m3rsm path with ``m3rsm_search_levels`` handed in in the
    kernel's place (a level-score launch a level, a batched score launch a
    hill-climb round): the same trajectory bit for bit; returns its
    launches."""
    from slam_constructor_tpu_torch.ops import kernels

    mc = cfg.matcher_cfg
    with handed_in(kernels.m3rsm_search_levels, "m3rsm_search"):
        reset_launches()
        got, _, secs, _ = run_main_path(cfg, scans, odom, gt, 0)
        launches = read_launches()
    want = expect(m3rsm_level=(mc.levels + 1) * N_SCANS, m3rsm_pyramid=N_SCANS + 1,
                  scan_insert=N_SCANS, prng_draws=N_SCANS, beam_weights=N_SCANS,
                  overlap_score_batched=(1 + mc.refine_iterations) * N_SCANS)
    diff = float((got - traj).abs().max())
    print(f"viny_m3rsm with a level launch a level and a score launch a hill-climb round: "
          f"{N_SCANS} scans at {N_SCANS / secs:.1f} scans/s; launches {launches} (expected "
          f"{want}); max|pose diff| to the one-launch match's run {diff:.3e}", flush=True)
    check(launches == want, f"viny_m3rsm levels path: launches {launches}, expected {want}")
    # the yardstick's hill climb in torch: the candidates' headings wrapped
    # once a score launch, the sine and cosine of the first pose once; its
    # endpoint cells' four fused multiply-adds (grid.endpoint_cells) once
    want_libm = expect_libm("viny_m3rsm")
    calls = (1 + mc.refine_iterations) * N_SCANS
    want_libm.update(wrap_angle=calls, sincos=N_SCANS, fma32=4 * N_SCANS,
                     total=want_libm["total"] + calls + 5 * N_SCANS)
    check_libm("viny_m3rsm levels path", want_libm)
    check(torch.equal(bits(got), bits(traj)),
          f"the one-launch match and the level launches give different trajectories: {diff}")
    return launches


def phase_m3rsm_match_many(cfg, e, scans, gt):
    """``m3rsm_match_many``: 8 requests (every 64th scan of the sequence,
    priors 0.1 m and 0.03 rad off) against the path's final map together,
    equal to 8 single calls bit for bit."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import m3rsm, scoring
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    view = scoring.MapView.of(e.state.gm, cfg.cell_model)
    idx = list(range(0, N_SCANS, 64))
    dev = gt.device
    priors = gt[idx] + torch.tensor([0.1, -0.05, 0.03], device=dev)
    batch = LaserScan(scans.ranges[idx], scans.bearings[idx], scans.valid[idx])
    pws = torch.stack([engine._point_weights(cfg, scans[i]) for i in idx])
    many = m3rsm.m3rsm_match_many(view, batch, priors, cfg.matcher_cfg, pws)
    singles = [m3rsm.m3rsm_match(view, scans[i], priors[b], None, cfg.matcher_cfg, pws[b])
               for b, i in enumerate(idx)]
    torch.cuda.synchronize()
    pose = torch.stack([s.pose for s in singles])
    prob = torch.stack([s.prob for s in singles])
    same = torch.equal(bits(many.pose), bits(pose)) and torch.equal(bits(many.prob), bits(prob))
    err = float((many.pose[:, :2] - gt[idx, :2]).abs().max())
    print(f"m3rsm_match_many: {len(idx)} requests on one map equal to {len(idx)} single calls bit "
          f"for bit: {same}; largest |x, y error| against the truth {err:.4f} m", flush=True)
    check(same, "m3rsm_match_many differs from single calls")

# --- slice 6a: the CLI and the gradient refine ---------------------------------


def cli_argv(name, out, dataset=None):
    n = CLI_RBPF_SCANS if name in ("gmapping", "tum_2d") else CLI_SCANS
    src = (["--dataset", dataset] if dataset else
           ["--synthetic", "cecum", "--trajectory", "rectangle", "--steps", str(n)])
    return ["--config", f"configs/{name}.properties", *src, "--out", out]


def cli_expected(name, n):
    """The launches the design gives a CLI run of ``n`` scans: one match a
    scan; tiny_refined's gradient refine and mit_csail's hill climb, one
    launch a scan each; the beam weights of the configs with the angle
    histogram (viny, viny_m3rsm, mit_stata), one launch a scan; viny_m3rsm's
    pyramid build in ``init_state`` and a
    refresh a scan; tum_2d's improved proposal (one batched score of the
    probes a scan); the draws, one launch a step (none where the tracker's
    Monte-Carlo match draws inside its launch) and one for the synthetic
    sequence."""
    # a Monte-Carlo tracker draws inside its match (engine.keyed_match)
    keyed = name in ("tiny", "viny", "mit_stata", "tiny_refined", "mit_csail")
    return expect(prng_draws=1 if keyed else n + 1, **{
        "tiny": dict(mc_match=n, scan_insert=n),
        "viny": dict(mc_match=n, scan_insert=n, beam_weights=n),
        "mit_stata": dict(mc_match=n, pool_prepare=n, pool_insert=n, beam_weights=n),
        "tiny_refined": dict(mc_match=n, gradient_refine=n, scan_insert=n),
        "mit_csail": dict(mc_match=n, hill_climb=n, scan_insert=n),
        "viny_m3rsm": dict(m3rsm_search=n, m3rsm_pyramid=n + 1, scan_insert=n, beam_weights=n),
        "gmapping": dict(mc_match_batched=n, scan_insert=n),
        "tum_2d": dict(mc_match_batched=n, overlap_score_batched=n, scan_insert=n),
    }[name])


def phase_cli(dev):
    """``slam_constructor_tpu_torch.run`` on every shipped config at its own
    widths, on the card, in this process, then tiny_refined and mit_csail
    once more with the refine's yardstick handed in. Returns the launches
    of each run; the arguments of every 16th refine of tiny_refined and
    mit_csail (`gradient_refine`, `hill_climb`); of the yardstick runs'
    every 97th `overlap_score_grad` launch and mit_csail's `overlap_score`
    launches every 16th scan (its first score, K = 1, and its first round,
    K = 6); the scans/s of the runs; and, for every config but mit_stata, the
    same engine once more with K3's twin handed in
    (:func:`held_to_twin_insert`: its kept insert calls and findings)."""
    from slam_constructor_tpu_torch import run
    from slam_constructor_tpu_torch.ops import blockmap, kernels
    from slam_constructor_tpu_torch.utils import config as cfglib
    from slam_constructor_tpu_torch.utils import evaluate

    launches, refine_kept, rates, trajs, inserts = {}, {}, {}, {}, {}
    for name in (*CLI_EARLIER, *CLI_NEW):
        args = run.parse_args(cli_argv(name, f"build/cli_out/{name}"))
        check(not args.cpu, "the CLI phase runs on the card")
        grad_rec, grad_k = recorder(kernels.gradient_refine, every=16)
        climb_rec, climb_k = recorder(kernels.hill_climb, every=16)
        reset_launches()
        with handed_in(grad_rec, "gradient_refine"), handed_in(climb_rec, "hill_climb"), \
                pool_twin_counted() as twin_calls:
            res = run.execute(args)
        launches[name] = read_launches()
        # the tiled map goes through the pool kernels, never a plain version
        check(not twin_calls, f"cli {name}: the pool's plain versions ran on the card's path: "
                              f"{sorted(set(twin_calls))}")
        refine_kept["gradient_refine"] = refine_kept.get("gradient_refine", []) + grad_k
        refine_kept["hill_climb"] = refine_kept.get("hill_climb", []) + climb_k
        n = res.trajectory.shape[0]
        want = cli_expected(name, n)
        sm = res.summary
        print(f"cli {name}: {n} scans, {sm['beams']} beams, {sm['scans_per_sec']} scans/s "
              f"({sm['wall_s']} s); ATE {sm['ate_m']} m, RPE {sm['rpe_t_m']} m / "
              f"{sm['rpe_r_rad']} rad; launches {launches[name]}", flush=True)
        check(launches[name] == want, f"cli {name}: launches {launches[name]}, expected {want}")
        check(res.engine.device.type == "cuda", f"cli {name} ran on {res.engine.device}")
        check(bool(torch.isfinite(res.trajectory).all()), f"cli {name}: non-finite poses")
        for f in ("trajectory.tum", "map.pgm", "map.yaml", "metrics.jsonl"):
            check(os.path.exists(os.path.join(args.out, f)), f"cli {name}: no {f}")

        # the same engine driven directly with the same config and seed, the
        # sync check on: the CLI's trajectory bit for bit
        scans, odom, gt = run.load_data(args, dev)
        props = cfglib.load_properties(args.config)
        if "pf.particles" in props:
            e, traj, _, secs = run_gmapping_path(cfglib.gmapping_config_from(props), scans, odom,
                                                 gt, "error")
        else:
            traj, _, secs, e = run_main_path(cfglib.engine_config_from(props), scans, odom, gt,
                                             "error")
        diff = float((traj - res.trajectory).abs().max())
        print(f"cli {name}: the engine driven directly, sync check on, {n / secs:.1f} scans/s; "
              f"max|pose diff| to the CLI's {diff:.3e}", flush=True)
        check(torch.equal(traj, res.trajectory), f"cli {name}: the CLI and the engine differ")
        rates[name] = {"cli": sm["scans_per_sec"], "direct": n / secs}
        trajs[name] = traj
        if name == "mit_stata":  # the tiled map: K3 over its block pool
            def again(p=props, s=scans, o=odom, g=gt):
                return run_main_path(cfglib.engine_config_from(p), s, o, g, 0)[0]
            inserts[name] = held_to_twin_pool(f"cli {name}", again, traj, POOL_EVERY)
        else:
            if "pf.particles" in props:
                def again(p=props, s=scans, o=odom, g=gt):
                    return run_gmapping_path(cfglib.gmapping_config_from(p), s, o, g, 0)[1]
            else:
                def again(p=props, s=scans, o=odom, g=gt):
                    return run_main_path(cfglib.engine_config_from(p), s, o, g, 0)[0]
            inserts[name] = held_to_twin_insert(f"cli {name}", again, traj, every=32)
        if name in CLI_NEW:
            ate = float(evaluate.ate(res.trajectory, gt, align=False))
            limit = max(CLI_REFERENCE_ATE_BY_KEY[name]) + CLI_ATE_MARGIN
            print(f"cli {name}: ATE {ate:.5f} m (limit {limit:.5f}: the JAX reference's worst "
                  f"of five keys {max(CLI_REFERENCE_ATE_BY_KEY[name]):.5f} + "
                  f"{CLI_ATE_MARGIN})", flush=True)
            check(ate <= limit, f"cli {name}: ATE {ate} above {limit}")
        if name == "mit_stata":
            bm = res.engine.state.gm
            frac = float(blockmap.allocated_fraction(bm))
            print(f"cli mit_stata: {int(bm.n_alloc)} of {bm.capacity} blocks of {bm.block}^2 "
                  f"allocated ({frac:.4f}); the table {tuple(bm.table.shape)} tiles", flush=True)
            check(not bool(bm.overflowed), "cli mit_stata: the block pool ran out")
        if name in CLI_NEW:
            phase_card_vs_cpu(name, cfglib.engine_config_from(props), dev, scans, odom, gt)

    for name, log in (("tiny", "mini_flaser.clf"), ("tiny", "mini_robotlaser.clf"),
                      ("gmapping", "mini_flaser.clf"), ("gmapping", "mini_robotlaser.clf")):
        args = run.parse_args(cli_argv(name, f"build/cli_out/{name}_{log}", f"tests/data/{log}"))
        reset_launches()
        res = run.execute(args)
        got = read_launches()
        n = res.trajectory.shape[0]
        want = expect(scan_insert=n, **({"mc_match": n} if name == "tiny"
                                        else {"mc_match_batched": n, "prng_draws": n}))
        launches[f"{name} on {log}"] = got
        print(f"cli {name} on {log}: {json.dumps(res.summary)}; launches {got}", flush=True)
        check(got == want, f"cli {name} on {log}: launches {got}, expected {want}")
        check(bool(torch.isfinite(res.trajectory).all()), f"cli {name} on {log}: non-finite")

    # the two refine paths with the yardstick (a score launch a pass) handed
    # in in the kernel's place, through the CLI and driven directly: the
    # same trajectories bit for bit
    grad_rec, grad_kept = recorder(kernels.overlap_score_grad, every=97)
    # mit_csail scores 11 times a scan: the first score, then 10 rounds
    score_rec, score_kept = recorder(kernels.overlap_score, keep=lambda n: n % 176 in (0, 1))
    for name, kernel, yardstick, score, passes in (
            ("tiny_refined", "gradient_refine", kernels.gradient_refine_rounds,
             "overlap_score_grad", 13),
            ("mit_csail", "hill_climb", kernels.hill_climb_rounds, "overlap_score", 11)):
        args = run.parse_args(cli_argv(name, f"build/cli_out/{name}_rounds"))
        with handed_in(yardstick, kernel):
            reset_launches()
            with handed_in(grad_rec, "overlap_score_grad"), handed_in(score_rec, "overlap_score"):
                res = run.execute(args)
            got = read_launches()
            scans, odom, gt = run.load_data(args, dev)
            traj, _, secs, _ = run_main_path(
                cfglib.engine_config_from(cfglib.load_properties(args.config)), scans, odom, gt,
                "error")
        n = res.trajectory.shape[0]
        launches[f"{name}, one {score} launch a pass"] = got
        want = expect(mc_match=n, scan_insert=n, prng_draws=1, **{score: passes * n})
        rates[f"{name}, yardstick"] = {"cli": res.summary["scans_per_sec"], "direct": n / secs}
        print(f"cli {name} with {yardstick.__name__} handed in: {res.summary['scans_per_sec']} "
              f"scans/s (the kernel's run {rates[name]['cli']}); driven directly, sync check on, "
              f"{n / secs:.1f} scans/s (the kernel's {rates[name]['direct']:.1f}); launches {got} "
              f"(expected {want}); the same trajectory as with `{kernel}` bit for bit: "
              f"{torch.equal(res.trajectory, trajs[name]) and torch.equal(traj, trajs[name])}",
              flush=True)
        check(got == want, f"cli {name} with the yardstick: launches {got}, expected {want}")
        check(torch.equal(res.trajectory, trajs[name]) and torch.equal(traj, trajs[name]),
              f"cli {name}: `{kernel}` and its yardstick give different trajectories")
    print("refine paths, scans/s driven directly (CLI): " + "; ".join(
        f"{k} {v['direct']:.1f} ({v['cli']})" for k, v in rates.items()
        if k.startswith(("tiny", "mit_csail"))), flush=True)
    return launches, grad_kept, score_kept, refine_kept, rates, inserts


def tap_cells(v, poses, pts, beam_w, origin, scale):
    """The distinct cells of plane ``v`` that K1's 2 x 2 taps read for
    these poses and the beams of nonzero weight (a tap off the map reads
    nothing), and the distinct 32-byte sectors that hold them: what a
    score or its gradient must read of the plane."""
    h, w = v.shape
    pts = pts[beam_w != 0]
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = (poses[:, 0:1] + c * pts[:, 0] - s * pts[:, 1] - origin[0]) / scale
    y = (poses[:, 1:2] + s * pts[:, 0] + c * pts[:, 1] - origin[1]) / scale
    f = torch.stack([torch.floor(y - 0.5), torch.floor(x - 0.5)]).reshape(2, -1)
    rows = torch.stack([f[0], f[0] + 1])[:, None]  # [2, 1, N]
    cols = torch.stack([f[1], f[1] + 1])[None, :]  # [1, 2, N]
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    cell = (rows * w + cols)[ok].to(torch.int64).unique()
    return int(cell.numel()), int((cell // 8).unique().numel())


def score_bytes(v, poses, pts, beam_w, origin, scale, per_pose_out):
    """Bytes a score (``per_pose_out`` 1) or a score and its gradient (4)
    must move: the tap cells, the poses, the weighted beams' points, every
    beam's weight, the origin, the outputs. Returns (bytes, cells,
    sectors)."""
    cells, sectors = tap_cells(v, poses, pts, beam_w, origin, scale)
    n_w = int((beam_w != 0).sum())
    return (4 * (cells + poses.numel() + 2 * n_w + beam_w.numel() + 2)
            + 4 * per_pose_out * poses.shape[0], cells, sectors)


def tap_cells_maps(v, poses, pts, beam_w, origin, scale):
    """:func:`tap_cells` summed over M maps: every tensor with a leading map
    dimension, each map's poses on its own plane."""
    cells = sectors = 0
    for m in range(v.shape[0]):
        c, sec = tap_cells(v[m], poses[m], pts[m], beam_w[m], origin[m], scale)
        cells, sectors = cells + c, sectors + sec
    return cells, sectors


def visited_poses(loop, score, args):
    """Every pose that ``loop`` (a match or refine loop of ``kernels``) scores
    on ``args`` when it scores with ``score`` (a kernel whose bits the fused
    kernel has): f32[..., N, 3], the calls' poses along the pose axis."""
    seen = []

    def recording(v, poses, *a):
        seen.append(poses)
        return score(v, poses, *a)

    loop(recording, *args)
    return torch.cat(seen, dim=-2)


def phase_overlap_csail(dev, k1, kept):
    """`overlap_score` against its plain twin on launches kept from the CLI's
    mit_csail run (its main path: the hill climb's first score, K = 1, and
    a round, K = 6, on the 1024^2 plane at 0.05 m); times the round and
    sets the `kernels` entry's times and bound to that shape."""
    from slam_constructor_tpu_torch.ops import kernels

    ks = sorted({a[1].shape[0] for a in kept})
    check(ks == [1, 6], f"mit_csail's kept overlap_score launches have K in {ks}, not 1 and 6")
    max_err = 0.0
    for i, args in enumerate(kept):
        got = kernels.overlap_score(*args)
        want = kernels.overlap_score_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"mit_csail launch {i}: not finite")
        print(f"overlap_score vs plain [mit_csail kept launch {i}]: K={args[1].shape[0]} "
              f"R={args[2].shape[0]} {args[0].shape[0]}x{args[0].shape[1]} "
              f"max|diff|={err:.3e} (tol {TOL:g})", flush=True)
        check(err <= TOL, f"mit_csail launch {i}: kernel disagrees with plain twin: {err}")
        max_err = max(max_err, err)
    args = [a for a in kept if a[1].shape[0] == 6][-1]  # a round on the fullest map
    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score(*args),
                                      lambda: kernels.overlap_score_ref(*args))
    device_ms = graph_ms(lambda: kernels.overlap_score(*args))
    n_bytes, cells, sectors = score_bytes(*args[:6], per_pose_out=1)
    n_ops = OVERLAP_OPS_PER_POINT * args[1].shape[0] * int((args[3] != 0).sum())
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score mit_csail round K=6 R={args[2].shape[0]} "
          f"{args[0].shape[0]}x{args[0].shape[1]}: {device_ms:.5f} ms on the device (50 launches "
          f"replayed from a CUDA graph), a call {ms:.4f} ms, chained {chained:.4f} ms; plain "
          f"{plain_ms:.4f} ms; bound {b_ms:.7f} ms by {by} ({n_bytes} B: {cells} tap cells in "
          f"{sectors} 32-B sectors; {n_ops} operations)", flush=True)
    k1.update({"max_abs_err": max(k1["max_abs_err"], max_err), "ms": ms, "plain_ms": plain_ms,
               "chained_ms": chained, "device_ms": device_ms, "bound_ms": b_ms, "bound_by": by,
               "timed_at": "mit_csail's hill-climb round, K=6, 1024^2"})


def phase_overlap_grad_kernel(dev, kept, smi):
    """`overlap_score_grad` against its autograd twin on launches kept from
    the tiny_refined path and hand-made cases; returns the `kernels` entry
    without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    check(len(kept) > 0, "no gradient launch was kept from the tiny_refined path")
    g = torch.Generator(device=dev).manual_seed(11)
    # the last kept launch: a map of many scans (the first is of an empty map)
    v, poses, pts, beam_w, origin, scale, unknown = kept[-1][:7]
    h, w = v.shape
    edge = torch.tensor([[float(origin[0]) + 0.4, float(origin[1]) + h * scale / 2, 2.8]],
                        device=dev)
    many = poses + torch.randn((7, 3), generator=g, device=dev) * torch.tensor(
        [0.05, 0.05, 0.03], device=dev)
    weights = torch.rand(beam_w[::2].shape, generator=g, device=dev)
    cases = [(f"tiny_refined launch {97 * i}", a) for i, a in enumerate(kept)]
    cases += [
        ("a pose 0.4 m from the map's edge", (v, edge, pts, beam_w, origin, scale, unknown)),
        ("K = 7", (v, many, pts, beam_w, origin, scale, unknown)),
        ("every second beam, beam weights",
         (v, many, pts[::2].contiguous(), (beam_w[::2] * weights).contiguous(), origin, scale,
          unknown)),
    ]
    max_err = 0.0
    for name, args in cases:
        score, _ = kernels.overlap_score_grad(*args)
        want_s, _ = kernels.overlap_score_grad_ref(*args)
        plain = kernels.overlap_score(*args)
        # the gradients are compared with the beams near a kink at weight 0
        clear = kernels.clear_of_kinks(args[1], args[2], args[4], args[5], KINK_MARGIN)
        masked = (*args[:3], (args[3] * clear).contiguous(), *args[4:])
        _, grad = kernels.overlap_score_grad(*masked)
        _, want_g = kernels.overlap_score_grad_ref(*masked)
        torch.cuda.synchronize()
        s_err = float((score - want_s).abs().max())
        g_err = float(((grad - want_g).abs() / want_g.norm(dim=1, keepdim=True).clamp(min=1.0)
                       ).max())
        print(f"overlap_score_grad vs autograd twin [{name}]: K={args[1].shape[0]} "
              f"R={args[2].shape[0]} score max|diff| {s_err:.3e} (tol {TOL:g}), gradient "
              f"max|diff| / max(1, |g|) {g_err:.3e} (tol {GRAD_TOL:g}; "
              f"{int((~clear).sum())} beams within {KINK_MARGIN:g} cell of a kink at weight 0), "
              f"|g| up to {float(want_g.norm(dim=1).max()):.3f}", flush=True)
        check(torch.equal(score, plain), f"{name}: the score is not overlap_score's bits")
        check(bool(torch.isfinite(grad).all()), f"{name}: gradient not finite")
        check(s_err <= TOL and g_err <= GRAD_TOL, f"{name}: the gradient kernel disagrees")
        max_err = max(max_err, s_err, float((grad - want_g).abs().max()))

    args = kept[-1]
    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_grad(*args),
                                      lambda: kernels.overlap_score_grad_ref(*args))
    device_ms = graph_ms(lambda: kernels.overlap_score_grad(*args))
    k = args[1].shape[0]
    n_bytes, cells, sectors = score_bytes(*args[:6], per_pose_out=4)
    n_ops = GRAD_OPS_PER_POINT * k * int((args[3] != 0).sum())
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score_grad K={k} R={pts.shape[0]} {h}x{w}: {device_ms:.5f} ms on the device "
          f"(50 launches replayed from a CUDA graph), a call {ms:.4f} ms, chained {chained:.4f} "
          f"ms; autograd twin {plain_ms:.4f} ms; bound {b_ms:.7f} ms by {by} ({n_bytes} B: "
          f"{cells} tap cells in {sectors} 32-B sectors; {n_ops} operations); no single PyTorch "
          f"call computes it; {smi}", flush=True)
    return {
        "name": "overlap_score_grad", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score_grad.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "differentiates": "slam_constructor_tpu/ops/matchers.py:230",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "device_ms": device_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def refine_cases(name, kept, dev):
    """(name, args) of the refine ``name`` ("gradient_refine" or
    "hill_climb"): the refines kept from its CLI path and edge cases made
    from the last of them (its map has the most scans): 0, 1 and twice the
    path's iterations, a start pose 0.4 m from the map's edge, every second
    beam with beam weights, no valid beam, a NaN weight; for the hill climb
    also M maps in one launch (the kept refines stacked, M = 8, and 32 with
    the start poses moved)."""
    g = torch.Generator(device=dev).manual_seed(13)
    cases = [(f"{name} scan {16 * i}", a) for i, a in enumerate(kept)]
    # the hill climb's arguments end with its reducer, the gradient's do not
    plane, pts, beam_w, origin, pose, scale, unknown, sxy, sth, iters, shrink = kept[-1][:11]
    h = plane.shape[0]

    def edited(**kw):
        names = ("plane", "pts", "beam_w", "origin", "pose", "scale", "unknown", "step_xy",
                 "step_theta", "iterations", "shrink", "reducer")
        return tuple(kw.get(n, a) for n, a in zip(names, kept[-1]))

    for n in (0, 1, 2 * iters):
        cases.append((f"{n} iterations", edited(iterations=n)))
    edge = torch.stack([origin[0] + 0.4, origin[1] + h * scale / 2, pose[2]])
    cases.append(("a start pose 0.4 m from the map's edge", edited(pose=edge.contiguous())))
    w = torch.rand(beam_w[::2].shape, generator=g, device=dev)
    cases.append(("every second beam, beam weights",
                  edited(pts=pts[::2].contiguous(), beam_w=(beam_w[::2] * w).contiguous())))
    cases.append(("no valid beam", edited(beam_w=torch.zeros_like(beam_w))))
    nan_w = beam_w.clone()
    nan_w[5] = float("nan")
    cases.append(("a NaN beam weight: NaN scores, never better", edited(beam_w=nan_w)))
    if name == "hill_climb":
        many = kept[-8:]
        check(len(many) == 8 and len({a[0].shape for a in many}) == 1,
              f"{len(many)} hill climbs kept of one shape")
        stacked = tuple(torch.stack([a[i] for a in many]).contiguous() for i in range(5))
        cases.append(("M = 8 maps: the kept climbs in one launch", stacked + kept[-1][5:]))
        four = tuple(t.repeat(4, *([1] * (t.dim() - 1))) for t in stacked)
        moved = four[4] + torch.randn((32, 3), generator=g, device=dev) * torch.tensor(
            [0.05, 0.05, 0.02], device=dev)
        cases.append(("M = 32 maps, the start poses moved",
                      four[:4] + (moved.contiguous(),) + kept[-1][5:]))
    return cases


def phase_refine_kernel(dev, name, kept, rates, smi):
    """A one-launch refine (`gradient_refine` or `hill_climb`) on the
    refines kept from its CLI path and edge cases: bit for bit equal to its
    yardstick (a score launch a pass) and, for `hill_climb` on M maps, to M
    single launches; against its plain twin, prob and trace within 2e-6 and
    the pose within 1e-5, or where they part a decision before it closer
    than 4e-6 (printed); then timed at the path's shape beside its
    yardstick and its twin, with its bound by the distinct cells the taps
    of every pose it scores read. Returns the `kernels` entry without the
    launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    grad = name == "gradient_refine"
    kernel = getattr(kernels, name)
    yardstick = kernels.gradient_refine_rounds if grad else kernels.hill_climb_rounds
    twin = kernels.gradient_refine_ref if grad else kernels.hill_climb_ref
    loop = kernels.gradient_refine_loop if grad else kernels.hill_climb_loop
    twin_score = kernels.overlap_score_grad_ref if grad else kernels.overlap_score_ref
    path = "tiny_refined" if grad else "mit_csail"
    check(len(kept) == 8, f"{len(kept)} refines kept from the {path} path, not 8")
    max_err, parted = 0.0, 0
    for case, args in refine_cases(name, kept, dev):
        got = kernel(*args)
        want = yardstick(*args)
        lead = args[0].shape[:-2]
        # M maps: each map's climb also equals a single-map launch
        singles = [kernel(*(a[m] for a in args[:5]), *args[5:])
                   for m in range(lead[0] if lead else 0)]
        twin_out, margins = twin_record(args, loop, twin_score)
        torch.cuda.synchronize()
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
        check(same, f"{name} differs from its yardstick ({case}): pose {got[0].tolist()} vs "
                    f"{want[0].tolist()}")
        check(all(torch.equal(bits(a), bits(torch.stack(b))) for a, b in zip(got, zip(*singles))),
              f"{name} differs from single-map launches ({case})")
        check(got[0].shape == (*lead, 3) and got[2].shape == (*lead, args[9]),
              f"{name} output malformed ({case})")
        if lead:
            errs = [against_twin(f"{case}, map {m}", [t[m] for t in got],
                                 [t[m] for t in twin_out], margins[m], pose_tol=1e-5)
                    for m in range(lead[0])]
        else:
            errs = [against_twin(case, got, twin_out, margins, pose_tol=1e-5)]
        err = max(e for e, _ in errs)
        parted += sum(a for _, a in errs)
        max_err = max(max_err, err)
        print(f"{name} [{case}]: {'M=' + str(lead[0]) + ' ' if lead else ''}R'="
              f"{args[1].shape[-2]} {args[0].shape[-2]}x{args[0].shape[-1]} iterations={args[9]} "
              f"equal to {yardstick.__name__}{' and single-map launches' if lead else ''} bit for "
              f"bit; vs plain twin max|diff|={err:.3e} (tol {TOL:g})"
              f"{', parted' if any(a for _, a in errs) else ''}",
              flush=True)
    print(f"{name}: every case equal to its yardstick bit for bit; {parted} part from the plain "
          f"twin after a decision closer than {KNIFE_EDGE:g}", flush=True)

    args = kept[-1]  # the path's shape, on the map of the most scans
    ms, plain_ms, chained = time_pair(lambda: kernel(*args), lambda: twin(*args), plain_calls=10)
    device_ms = graph_ms(lambda: kernel(*args))
    rounds_ms = statistics.median(time_ms(lambda: yardstick(*args), 50))
    rounds_device_ms = graph_ms(lambda: yardstick(*args), n=10)
    score = kernels.overlap_score_grad if grad else kernels.overlap_score
    poses = visited_poses(loop, score, args)
    cells, sectors = tap_cells(args[0], poses, *args[1:4], args[5])
    n_w = int((args[2] != 0).sum())
    n_bytes = 4 * (cells + 2 * n_w + args[2].numel() + 2 + 3 + 3 + 1 + args[9])
    n_ops = (GRAD_OPS_PER_POINT if grad else OVERLAP_OPS_PER_POINT) * poses.shape[0] * n_w
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"{name} at the {path} path's shape (R'={args[1].shape[0]} "
          f"{args[0].shape[0]}x{args[0].shape[1]}, {args[9]} iterations, {poses.shape[0]} poses "
          f"scored): {device_ms:.5f} ms on the device (50 launches replayed from a CUDA graph), a "
          f"call {ms:.4f} ms, chained {chained:.4f} ms; the yardstick {rounds_ms:.4f} ms a call, "
          f"{rounds_device_ms:.5f} ms replayed from a CUDA graph; plain twin {plain_ms:.4f} ms; "
          f"bound {b_ms:.7f} ms by {by} ({n_bytes} B: {cells} tap cells in {sectors} 32-B "
          f"sectors; {n_ops} operations); no single PyTorch call computes it; {smi}", flush=True)
    return {
        "name": name, "route": "cuda",
        "source": f"slam_constructor_tpu_torch/csrc/{name}.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "refines": f"slam_constructor_tpu/ops/matchers.py:{217 if grad else 112}",
        "max_abs_err": max_err, "cases_parted_from_twin": parted, "ms": ms,
        "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device_ms,
        "rounds_ms": rounds_ms, "rounds_device_ms": rounds_device_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        "path_scans_per_s": {k: v for k, v in rates.items() if k.startswith(path) or k == "tiny"},
    }


# --- the reducers, and the BASELINE gmapping preset that scores with one -----


def baseline_engine(**kw):
    """``utils.config.preset('gmapping')``'s engine: ``GMappingEngine()`` at
    the reference's defaults (BASELINE config[2])."""
    from slam_constructor_tpu_torch.utils import config as cfglib

    return cfglib.preset("gmapping")(**kw)


def reducer_variants():
    """The reducers other than the bilinear overlap, as ``kernels.Reducer``:
    the obstacle reducer (the preset's), the max and the mean over 3^2 and
    5^2 cells, the overlap reducer at extents 0.5, 1.6 and 2.5."""
    from slam_constructor_tpu_torch.ops import kernels

    return [kernels.Reducer(kind, radius, extent) for kind, radius, extent in REDUCER_VARIANTS]


def variant_name(red):
    return red.kind if red.kind == "obstacle" else (
        f"{red.kind} w{red.radius}" + (f" e{red.extent:g}" if red.kind == "overlap" else ""))


def reducer_tap_cells(v, poses, pts, beam_w, origin, scale, red):
    """The distinct cells of each map of ``v`` f32[M, H, W] that the
    reducer's taps read (the cell of each weighted beam's endpoint and the
    window around it, on the map) for the poses f32[M, N, 3]."""
    h, w = v.shape[-2:]
    n = red.radius if red.kind != "obstacle" else 0
    d = torch.arange(-n, n + 1, device=v.device, dtype=torch.float32)
    cells = 0
    for m in range(v.shape[0]):
        q = pts[m][beam_w[m] != 0]
        c, s_ = torch.cos(poses[m, :, 2:3]), torch.sin(poses[m, :, 2:3])
        x = (poses[m, :, 0:1] + c * q[:, 0] - s_ * q[:, 1] - origin[m, 0]) / scale
        y = (poses[m, :, 1:2] + s_ * q[:, 0] + c * q[:, 1] - origin[m, 1]) / scale
        fy = torch.floor(y).reshape(-1)[:, None, None] + d[None, :, None]
        fx = torch.floor(x).reshape(-1)[:, None, None] + d[None, None, :]
        ok = (fy >= 0) & (fy < h) & (fx >= 0) & (fx < w)
        cells += int((fy * w + fx)[ok].to(torch.int64).unique().numel())
    return cells


def reducer_ops(red) -> int:
    """f32 operations a (pose, beam) pair of the reducer: the pose
    transform 8, to cell units 4, the floors 2, the weighted sum 3, and a
    cell's bounds and read 5 and its max or sum 1; the general overlap also
    its two overlap lengths (2 x 6), their product and its two sums (3),
    and a final division."""
    taps = 1 if red.kind == "obstacle" else (2 * red.radius + 1) ** 2
    per_cell = 6 + (15 if red.kind == "overlap" else 0)
    return 8 + 4 + 2 + 3 + taps * per_cell + (1 if red.kind in ("mean", "overlap") else 0)


def capture_baseline_matches(scans, odom, gt, every=32):
    """A warm-up run of the gmapping preset's path that keeps the arguments
    of every ``every``-th particle match (``mc_match_batched`` on the 30
    whole maps)."""
    from slam_constructor_tpu_torch.ops import kernels

    recording, kept = recorder(kernels.mc_match_batched, every)
    with handed_in(recording, "mc_match_batched"):
        run_gmapping_path(None, scans, odom, gt, 0, make=baseline_engine)
    return kept


def phase_reducer_kernels(dev, states, smi):
    """Every reducer variant (``reducer_variants``) in the scoring kernels
    at the gmapping preset's shapes (30 whole maps of 256^2, 360 beams, 6
    rounds of 16): ``mc_match_batched`` on the kept states (the obstacle
    reducer, the path's) and on one of them with every variant, equal to
    single launches and ``mc_match_rounds`` bit for bit and within 2e-6 of
    its twin (or parted after a decision closer than 4e-6); edge cases (a
    particle without a valid beam, a NaN weight, a pose off the map, windows
    clamped at the map's edges read in place against the same windows cut
    out); ``overlap_score`` and ``overlap_score_batched`` against the twin
    and single launches; ``hill_climb`` (one map and 30) against
    ``hill_climb_rounds``; ``m3rsm_search`` at ``M3RSMConfig()`` against
    ``m3rsm_search_levels``. Then each variant of the particle match
    timed: device time replayed from a CUDA graph, a call, chained, the
    twin, and the bound by the cells its taps read. Returns the `kernels`
    entries without the launch counts."""
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops import kernels, m3rsm, scoring

    s = states[8]  # scan 256
    check((tuple(s[0].shape), tuple(s[1].shape), tuple(s[5].shape), s[11].kind) ==
          ((GM_PARTICLES, MAP, MAP), (GM_PARTICLES, N_BEAMS, 2), (GM_PARTICLES, 6, 16, 3),
           "obstacle"),
          f"the gmapping preset's match reads {tuple(s[0].shape)} planes, pts {tuple(s[1].shape)}, "
          f"noise {tuple(s[5].shape)}, reducer {s[11]}: not 30 maps of 256^2, 360 beams, 6 rounds "
          f"of 16, the obstacle reducer")
    max_err, parted, n_cases = {}, {}, 0

    def matched(name, args):
        red = args[11]
        got = kernels.mc_match_batched(*args)
        twin, margins = twin_record(args)
        torch.cuda.synchronize()
        held_to_singles(name, got, args)
        errs = [against_twin(f"{name}, particle {m}", [t[m] for t in got], [t[m] for t in twin],
                             margins[m]) for m in range(args[0].shape[0])]
        key = variant_name(red)
        max_err[key] = max(max_err.get(key, 0.0), max(e for e, _ in errs))
        parted[key] = parted.get(key, 0) + sum(a for _, a in errs)
        return got

    for i, a in enumerate(states):
        matched(f"gmapping preset scan {32 * i}", a)
        n_cases += 1
    print(f"mc_match_batched, obstacle reducer: {len(states)} kept matches of the gmapping preset "
          f"(30 x 256^2, R=360, 6 rounds of 16) equal to 30 single launches and mc_match_rounds bit "
          f"for bit; vs twin max|diff| {max_err['obstacle']:.3e}, {parted['obstacle']} particles "
          f"parted after a decision closer than {KNIFE_EDGE:g}", flush=True)

    far = 2.0 * MAP * 0.1
    map_origin = torch.tensor([-MAP * 0.1 / 2.0, -MAP * 0.1 / 2.0], device=dev).expand(
        GM_PARTICLES, 2).contiguous()
    known = torch.ones_like(s[0], dtype=torch.bool)
    for red in reducer_variants():
        a = (*s[:11], red)
        name = variant_name(red)
        matched(f"{name}, scan 256", a)
        no_beam = a[2].clone()
        no_beam[3] = 0.0
        got = matched(f"{name}, particle 3 without a valid beam", (*a[:2], no_beam, *a[3:]))
        check(not bool(got[2][3].any()) and torch.equal(got[0][3], a[4][3]),
              f"{name}: a particle without a valid beam must score 0 and keep its prior")
        nan_w = a[2].clone()
        nan_w[5, 7] = float("nan")
        got = matched(f"{name}, a NaN weight", (*a[:2], nan_w, *a[3:]))
        check(bool(torch.isnan(got[1][5])) and torch.equal(got[0][5], a[4][5]),
              f"{name}: a NaN weight must give NaN scores that are never better")
        off = a[4].clone()
        off[0, :2] += far  # every endpoint off the map: every score `unknown`
        got = matched(f"{name}, a pose off the map", (*a[:4], off, *a[5:]))
        check(torch.equal(got[0][0], off[0]) and float(got[1][0]) == float(a[7]),
              f"{name}: a pose off the map must score unknown and stay")
        for label, dx, dy in (("left edge", -1, 0), ("top-right corner", 1, 1),
                              ("bottom edge", 0, -1)):
            centre = a[4][:, :2] + torch.tensor([dx * far, dy * far], device=dev)
            row, col, origin = gridlib.window_corner(map_origin, centre, 0.1, 160, 160, MAP, MAP)
            wargs = (a[0], known, row, col, 160, 160, a[1], a[2], origin, *a[4:])
            in_place = kernels.mc_match_windows(*wargs)
            cut = kernels.mc_match_batched(gridlib.take_window(a[0], row, col, 160, 160).contiguous(),
                                           *wargs[6:])
            torch.cuda.synchronize()
            check(all(torch.equal(bits(x), bits(y)) for x, y in zip(in_place, cut)),
                  f"{name}: windows clamped at the map's {label} read in place differ from the "
                  f"windows cut out")
        n_cases += 4
        # the other scoring kernels with the same reducer
        poses = (a[4][:, None, :] + draws_of(a[5])[:, 0] * 0.08).contiguous()  # 16 a map
        sargs = (a[0], poses, a[1], a[2], a[3], a[6], a[7], red)
        batched = kernels.overlap_score_batched(*sargs)
        single = torch.stack([kernels.overlap_score(*(t[m] for t in sargs[:5]), *sargs[5:])
                              for m in range(GM_PARTICLES)])
        err = float((batched - kernels.overlap_score_ref(*sargs)).abs().max())
        check(err <= TOL and torch.equal(bits(batched), bits(single)),
              f"{name}: overlap_score_batched {err:.3e} from its twin, or not the single launches' "
              f"bits")
        cargs = (a[0], a[1], a[2], a[3], a[4], a[6], a[7], 0.1, 0.05, 10, 0.5, red)
        climb = kernels.hill_climb(*cargs)
        check(all(torch.equal(bits(x), bits(y))
                  for x, y in zip(climb, kernels.hill_climb_rounds(*cargs))),
              f"{name}: hill_climb on 30 maps differs from hill_climb_rounds")
        one = kernels.hill_climb(*(t[0] for t in cargs[:5]), *cargs[5:])
        check(all(torch.equal(bits(x[0]), bits(y)) for x, y in zip(climb, one)),
              f"{name}: hill_climb on 30 maps differs from a single-map launch")
        view = scoring.MapView(occ=a[0][0], known=known[0], origin=a[3][0], scale=0.1)
        from slam_constructor_tpu_torch.ops.scan import LaserScan

        scan = LaserScan(torch.linalg.vector_norm(a[1][0], dim=-1),
                         torch.atan2(a[1][0][:, 1], a[1][0][:, 0]), a[2][0] > 0)
        mcfg = m3rsm.M3RSMConfig(scoring=scoring.ScoringConfig(
            reducer=red.kind, window=red.radius, overlap_extent=red.extent))
        got_m = m3rsm.m3rsm_match(view, scan, a[4][0], None, mcfg)
        with handed_in(kernels.m3rsm_search_levels, "m3rsm_search"):
            want_m = m3rsm.m3rsm_match(view, scan, a[4][0], None, mcfg)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(x), bits(y)) for x, y in
                  ((got_m.pose, want_m.pose), (got_m.prob, want_m.prob), (got_m.trace, want_m.trace))),
              f"{name}: m3rsm_search at M3RSMConfig() differs from m3rsm_search_levels")
        print(f"reducer {name}: mc_match_batched at the preset's shape and 4 edge cases (no valid "
              f"beam, a NaN weight, a pose off the map, windows clamped at 3 edges in place = cut "
              f"out) equal to single launches and mc_match_rounds bit for bit, vs twin max|diff| "
              f"{max_err[name]:.3e}, {parted[name]} parted after a close decision; "
              f"overlap_score_batched (M=30 K=16) {err:.3e} from its twin, = 30 single launches; "
              f"hill_climb (M=30 and 1, 10 rounds) = hill_climb_rounds; m3rsm_search at "
              f"M3RSMConfig() = m3rsm_search_levels", flush=True)

    entries = []
    for red in reducer_variants():
        a = (*s[:11], red)
        name = variant_name(red)
        ms, plain_ms, chained = time_pair(lambda: kernels.mc_match_batched(*a),
                                          lambda: kernels.mc_match_ref(*a), plain_calls=5)
        device_ms = graph_ms(lambda: kernels.mc_match_batched(*a), n=20)
        poses = visited_poses(kernels.mc_match_loop, kernels.overlap_score_batched, a)
        cells = reducer_tap_cells(a[0], poses, a[1], a[2], a[3], 0.1, red)
        n_w = int((a[2] != 0).sum())
        n_p, n_rounds, k = a[5].shape[:3]
        n_bytes = 4 * (cells + 2 * n_w + sum(t.numel() for t in a[2:6]) + n_p * (3 + 1 + n_rounds))
        n_ops = reducer_ops(red) * (1 + n_rounds * k) * n_w
        b_ms, by = bound_ms(n_bytes, n_ops)
        print(f"mc_match_batched [{name}] P={n_p} K={k} rounds={n_rounds} R=360 256^2 whole maps: "
              f"{device_ms:.5f} ms on the device (20 launches replayed from a CUDA graph), a call "
              f"{ms:.4f} ms, chained {chained:.4f} ms; plain twin {plain_ms:.4f} ms; bound "
              f"{b_ms:.7f} ms by {by} ({n_bytes} B: {cells} tap cells; {n_ops} operations); "
              f"{smi}", flush=True)
        entries.append({
            "name": f"mc_match_batched/{red.kind}" + (
                "" if red.kind == "obstacle" else f" w{red.radius}" +
                (f" e{red.extent:g}" if red.kind == "overlap" else "")),
            "route": "cuda", "source": "slam_constructor_tpu_torch/csrc/mc_match.cu",
            "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
            "reducer": f"slam_constructor_tpu/ops/scoring.py:{REDUCER_LINES[red.kind]}",
            "variant": name, "max_abs_err": max_err[name], "matches_parted_from_twin": parted[name],
            "ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None})
    print(f"reducer kernels: {n_cases} cases", flush=True)
    return entries


def phase_gmapping_baseline_path(scans, odom, gt, odo_ate, smi):
    """The gmapping preset's main path through ``preset('gmapping')``: the
    timed run (the warm-up was the capture) with the counts at 0 before and
    read after, under ``torch.cuda.set_sync_debug_mode("error")``; its
    checks; then ``run.py --preset gmapping`` in this process (its own
    synthetic sequence of 512 scans) against the engine driven directly.
    Returns the launch counts and those by reducer of the timed run."""
    from slam_constructor_tpu_torch import run
    from slam_constructor_tpu_torch.models import gmapping
    from slam_constructor_tpu_torch.ops import kernels
    from slam_constructor_tpu_torch.utils import evaluate

    reset_launches()
    e, traj, neffs, secs = run_gmapping_path(None, scans, odom, gt, "error", make=baseline_engine)
    launches, by_reducer = read_launches(), kernels.reducer_launch_counts()
    want = expect(mc_match_batched=N_SCANS, scan_insert=N_SCANS, prng_draws=N_SCANS)
    check(e.cfg == gmapping.GMappingConfig(), "preset('gmapping') is not GMappingConfig()")
    resamples = int((e.genealogy[1] != torch.arange(e.cfg.n_particles, device=traj.device))
                    .any(1).sum())
    print(f"gmapping preset main path (GMappingConfig(): {e.cfg.n_particles} particles, whole "
          f"{e.cfg.map_height}^2 maps, the obstacle reducer, {e.cfg.matcher_cfg.rounds} rounds of "
          f"{e.cfg.matcher_cfg.batch}): {N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} "
          f"scans/s on {smi}, with the sync check on, no host sync; {resamples} resamplings, min "
          f"Neff {float(neffs.min()):.2f}; launches {launches} (expected {want}); by reducer "
          f"{ {k: v for k, v in by_reducer.items() if v} }", flush=True)
    check(launches == want, f"gmapping preset: launches {launches}, expected {want}")
    check_libm("gmapping preset", expect_libm("gmapping"))
    check(by_reducer["mc_match_batched/obstacle"] == N_SCANS,
          "gmapping preset: the particle match did not score with the obstacle reducer")
    winner = e.winner_trajectory()
    check(winner.shape == (N_SCANS, 3) and bool(torch.isfinite(winner).all())
          and bool(torch.isfinite(traj).all()), "gmapping preset: non-finite poses")
    ate = float(evaluate.ate(winner, gt, align=False))
    online = float(evaluate.ate(traj, gt, align=False))
    limit = max(GMAPPING_BASELINE_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping preset main path: winner ATE {ate:.4f} m (no alignment; limit: the "
          f"reference's worst key + margin {limit:.4f}; its five keys "
          f"{min(GMAPPING_BASELINE_REFERENCE_ATE_BY_KEY):.4f}-"
          f"{max(GMAPPING_BASELINE_REFERENCE_ATE_BY_KEY):.4f}), online {online:.4f} m, odometry "
          f"only {odo_ate:.4f} m (trap j: four of the reference's five keys beat it, key 1 does "
          f"not)",
          flush=True)
    check(ate <= limit, f"gmapping preset: winner ATE {ate} above the reference's worst key + "
                        f"margin")

    args = run.parse_args(["--preset", "gmapping", "--synthetic", "cecum", "--trajectory",
                           "rectangle", "--steps", str(N_SCANS), "--out", "build/cli_out/preset"])
    reset_launches()
    res = run.execute(args)
    cli = read_launches()
    # the CLI's synthetic sequence is drawn from its key too: one more draw
    check(cli == {**want, "prng_draws": N_SCANS + 1} and res.engine.device.type == "cuda"
          and bool(torch.isfinite(res.trajectory).all()),
          f"run.py --preset gmapping: launches {cli}, device {res.engine.device}")
    cscans, codom, cgt = run.load_data(args, scans.ranges.device)
    _, direct, _, dsecs = run_gmapping_path(None, cscans, codom, cgt, "error", make=baseline_engine)
    check(torch.equal(direct, res.trajectory),
          "run.py --preset gmapping and the preset's engine driven directly differ")
    sm = res.summary
    print(f"run.py --preset gmapping: {sm['scans']} scans of its synthetic rectangle, "
          f"{sm['scans_per_sec']} scans/s ({sm['wall_s']} s); ATE {sm['ate_m']} m; launches {cli}; "
          f"equal to the engine driven directly with the sync check on ({N_SCANS / dsecs:.1f} "
          f"scans/s) bit for bit", flush=True)
    return launches, by_reducer


def insert_call(args, kwargs):
    """A ``scan_insert`` call's arguments as (gm, model, pose, scan, beam,
    q, window), the map's cells, the pose, the scan and q cloned."""
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    a = dict(zip(("gm", "model", "pose", "scan", "cfg", "q", "window"), args), **kwargs)
    gm, scan, q = a["gm"], a["scan"], a.get("q")
    return (gridlib.GridMap(cells=gm.cells.clone(), origin=gm.origin.clone(), scale=gm.scale),
            a["model"], a["pose"].clone(),
            LaserScan(scan.ranges.clone(), scan.bearings.clone(), scan.valid.clone()), a["cfg"],
            None if q is None else q.clone(), a.get("window", 0))


def held_to_twin_insert(name, run, traj=None, every=INSERT_EVERY):
    """The path's trajectory through K3 (``traj``, or ``run()``'s) against
    a run with K3's plain twin handed in (``kernels.scan_insert_ref``, the
    card's ``index_put_``), in which the kernel also runs on every call's
    arguments: the trajectories bit for bit, or, where they part, the
    first scan, and an insert at or before it whose kernel and twin cells
    differed (the card's ``index_put_`` sums a cell's run of 32 samples or
    more in another order). ``run()`` returns the trajectory f32[T, 3] of a
    run that inserts once a scan. Returns the kept calls (every
    ``every``-th) and what was found."""
    from slam_constructor_tpu_torch.ops import kernels

    if traj is None:
        traj = run()
    kernel, kept, n, first = kernels.scan_insert, [], [0], [None]

    def stand_in(*args, **kwargs):
        twin = kernels.scan_insert_ref(*args, **kwargs)
        if first[0] is None and not torch.equal(bits(twin), bits(kernel(*args, **kwargs))):
            first[0] = n[0]
        if n[0] % every == 0:
            kept.append(insert_call(args, kwargs))
        n[0] += 1
        return twin

    with handed_in(stand_in, "scan_insert"):
        twin_traj = run()
    apart = (bits(traj).reshape(traj.shape) != bits(twin_traj).reshape(traj.shape)).any(-1)
    part = int(apart.nonzero()[0]) if bool(apart.any()) else None
    print(f"{name} with K3's plain twin handed in: {n[0]} inserts, the first whose cells differ "
          f"from the kernel's {first[0]}; the trajectory "
          f"{'equal to the kernel path bit for bit' if part is None else f'parts at scan {part}'}",
          flush=True)
    check(part is None or (first[0] is not None and first[0] <= part),
          f"{name}: the twin insert's trajectory parts at scan {part} with no insert before it "
          f"differing from the kernel's")
    return kept, {"inserts": n[0], "first_insert_differing_from_twin": first[0],
                  "trajectory_parts_at_scan": part}


def insert_window_mask(args):
    """bool[P, H, W]: the cells of each map that the insert folds."""
    from slam_constructor_tpu_torch.ops import grid as gridlib

    gm, _, pose, _, _, _, window = args
    if gm.cells.dim() == 3 or not window:
        return torch.ones(gm.cells.shape[:-1], dtype=torch.bool,
                          device=gm.cells.device).reshape(-1, gm.height, gm.width)
    sh = sw = min(window, gm.height, gm.width)
    row, col, _ = gridlib.window_corner(gm.origin, pose[:, :2], gm.scale, sh, sw, gm.height,
                                        gm.width)
    r = torch.arange(gm.height, device=row.device)
    c = torch.arange(gm.width, device=row.device)
    return (((r[None, :] >= row[:, None]) & (r[None, :] < row[:, None] + sh))[:, :, None]
            & ((c[None, :] >= col[:, None]) & (c[None, :] < col[:, None] + sw))[:, None, :])


def insert_work(args):
    """(bytes, operations, cells folded) of one insert on these inputs: the
    maps read and written once, the scan's rows (a broadcast row once),
    poses, origins, q and the polar plane read once; the operations of the
    beams, of the DDA samples before each beam's free limit, of the
    occupied samples of the beams that carry evidence and of the folded
    cells (the K3_* counts)."""
    gm, model, pose, scan, cfg, q, window = args
    n_p = 1 if gm.cells.dim() == 3 else gm.cells.shape[0]
    r = scan.ranges.shape[-1]
    folded = int(insert_window_mask(args).sum())
    rows = 1 if scan.ranges.dim() == 1 or scan.ranges.stride(0) == 0 else n_p
    polar = cfg.free_impl == "polar"
    n_bytes = (8 * gm.cells.numel() + 9 * r * rows + 20 * n_p + (4 if q is not None else 0)
               + (4 * folded if polar else 0))
    ranges, valid = scan.ranges.reshape(-1, r), scan.valid.reshape(-1, r)
    traced = 0
    if not polar:
        n_s = cfg.n_free_samples(gm.scale)
        t = (torch.arange(n_s, dtype=torch.float32, device=ranges.device) + 0.5) * (
            gm.scale * cfg.step_fraction)
        traced = int(((t < (ranges - cfg.hole_width / 2.0)[..., None]) & valid[..., None]).sum())
        traced *= n_p // ranges.shape[0]
    ep = int((valid & (ranges <= cfg.max_range)).sum()) * (n_p // ranges.shape[0])
    area = cfg.occupancy_estimator == "area"
    occ = ep * ((9 if area else 1) + (cfg.blur_samples if cfg.wall_blur else 0))
    n_ops = (K3_BEAM_OPS * n_p * r + K3_FREE_OPS * traced + K3_OCC_OPS * occ
             + (K3_AREA_OPS * 9 * ep if area else 0) + K3_FOLD_OPS[type(model).__name__] * folded)
    return n_bytes, n_ops, folded


def insert_edge_cases(kept):
    """(name, args) of the edge cases, made from kept path states."""
    from slam_constructor_tpu_torch.ops import grid as gridlib
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    gm, model, pose, scan, cfg, q, w = kept["tiny"][4]
    cases = [("tiny state, q = 0", (gm, model, pose, scan, cfg, torch.zeros_like(q), w)),
             ("tiny state, no valid beam",
              (gm, model, pose, LaserScan(scan.ranges, scan.bearings,
                                          torch.zeros_like(scan.valid)), cfg, q, w)),
             ("tiny state, every beam past a usable range of 1 m",
              (gm, model, pose, scan, dataclasses.replace(cfg, max_range=1.0), q, w))]
    cut = gridlib.GridMap(cells=gm.cells[96:160, 96:160].contiguous(),
                          origin=gm.origin + 96 * gm.scale, scale=gm.scale)
    cases.append(("tiny state on a 64^2 map: endpoints and free samples off it",
                  (cut, model, pose, scan, cfg, q, w)))
    # beam 90 runs along the boundary of rows 127 and 128 (a band's edge)
    boundary = torch.stack([pose[0], gm.origin[1] + 128 * gm.scale, -scan.bearings[90]])
    cases.append(("tiny state, a beam along the boundary of two rows",
                  (gm, model, boundary, scan, cfg, q, w)))
    area = dataclasses.replace(cfg, occupancy_estimator="area")
    cases.append(("tiny state, the area estimator and the blur at 360 beams",
                  (gm, model, pose, scan, area, q, w)))
    dev = pose.device
    ones = torch.ones(1024, dtype=torch.bool, device=dev)
    cases.append(("tiny state, 1,024 beams into one cell: a run over chunks of 512",
                  (gm, model, pose, LaserScan(torch.full((1024,), 2.0, device=dev),
                                              torch.full((1024,), 0.3, device=dev), ones),
                   cfg, q, w)))
    # 3,000 x (9 + 4) occupied samples: the old sort took 16,384 keys at most
    cases.append(("tiny state, 3,000 beams with the area estimator: 39,000 occupied samples",
                  (gm, model, pose, LaserScan(torch.full((3000,), 2.0, device=dev),
                                              torch.linspace(-3.0, 3.0, 3000, device=dev) + 0.3,
                                              torch.ones(3000, dtype=torch.bool, device=dev)),
                   area, q, w)))
    gm, model, pose, scan, cfg, q, w = kept["gmapping"][4]
    far = gm.origin + torch.tensor([gm.width, gm.height], device=pose.device) * gm.scale
    corners = pose.clone()
    corners[0, :2] = gm.origin[0] + 0.3
    corners[1, :2] = far[1] - 0.3
    corners[2, 0], corners[3, 1] = gm.origin[2, 0] + 0.3, far[3, 1] - 0.3
    cases.append(("gmapping state, windows clamped at two corners and two edges",
                  (gm, model, corners, scan, cfg, q, w)))
    edges = pose.clone()
    edges[0, 0], edges[1, 0] = gm.origin[0, 0] + 0.3, far[1, 0] - 0.3
    edges[2, 1], edges[3, 1] = gm.origin[2, 1] + 0.3, far[3, 1] - 0.3
    edges[4, :2], edges[5, :2] = gm.origin[4] + 0.3, far[5] - 0.3
    cases.append(("gmapping state, windows clamped at each of the four edges and two corners",
                  (gm, model, edges, scan, cfg, q, w)))
    gm, model, pose, scan, cfg, q, _ = kept["viny"][4]
    n_p = 4
    stack = gridlib.GridMap(cells=gm.cells.expand(n_p, *gm.cells.shape).contiguous(),
                            origin=gm.origin.expand(n_p, 2).contiguous(), scale=gm.scale)
    poses = pose.expand(n_p, 3).clone()
    poses[1:, 0] += torch.tensor([0.5, -0.7, 9.0], device=pose.device)
    cases.append(("viny state as 4 windows of 160^2 (TBM, the polar fill), one clamped",
                  (stack, model, poses, LaserScan(*(t.expand(n_p, -1) for t in (
                      scan.ranges, scan.bearings, scan.valid))), cfg, None, 160)))
    return cases


def phase_scan_insert_kernel(dev, kept, smi):
    """K3 (``kernels.scan_insert``) on the insert calls kept from every
    path's run with its twin handed in and on edge cases: equal to the
    ordered sums (``scan_insert_ordered``) bit for bit, two launches the
    same bits, against the twin bit for bit but in the cells whose run of
    occupied samples the card's ``index_put_`` sums in another order (32
    or more; within 1e-6 relative); the cells outside the windows copied.
    Then timed at each path's shape. Returns the ``kernels`` entry without
    the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    cases = [(f"{path} insert {i * INSERT_EVERY}", a) for path, calls in kept.items()
             for i, a in enumerate(calls)]
    cases += insert_edge_cases(kept)
    max_err, explained = 0.0, 0
    for name, args in cases:
        before = kernels.launch_counts()["scan_insert"]
        got = kernels.scan_insert(*args)
        again = kernels.scan_insert(*args)
        want = kernels.scan_insert_ordered(*args)
        twin = kernels.scan_insert_ref(*args)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["scan_insert"] == before + 2,
              f"scan_insert did not count its launches ({name})")
        gm = args[0]
        check(got.shape == gm.cells.shape and bool(torch.isfinite(got).all()),
              f"scan_insert output malformed ({name})")
        same = torch.equal(bits(got), bits(want))
        check(same, f"scan_insert differs from the ordered sums ({name}): "
                    f"{int((got != want).any(-1).sum())} cells")
        check(torch.equal(bits(got), bits(again)), f"two launches differ ({name})")
        inside = insert_window_mask(args)
        lead = (-1, *got.shape[-3:])
        cells_got, cells_in = got.reshape(lead), gm.cells.reshape(lead)
        check(torch.equal(bits(cells_got[~inside]), bits(cells_in[~inside])),
              f"scan_insert changed cells outside the windows ({name})")
        differ = (got.view(torch.int32) != twin.view(torch.int32)).any(-1).reshape(inside.shape)
        runs = kernels.scan_insert_runs(args[0], args[2], args[3], args[4], args[6])
        n_differ = int(differ.sum())
        short = int((differ[inside].reshape(runs.shape) & (runs < 32)).sum()) if n_differ else 0
        rel = float(((got - twin).abs() / twin.abs().clamp(min=1e-30)).max())
        longest = int(runs.max())
        tol = 1e-6 if longest < LONG_RUN else longest * 2.0**-24
        print(f"scan_insert [{name}]: {tuple(gm.cells.shape)}, window {args[6]}, q "
              f"{None if args[5] is None else float(args[5])}: equal to the ordered sums bit for "
              f"bit, two launches equal; against the twin {n_differ} cells differ (all in cells "
              f"with 32 or more occupied samples: {short == 0}; largest run "
              f"{longest}), max relative difference {rel:.3e} (at most {tol:.3e})", flush=True)
        check(short == 0 and rel <= tol, f"scan_insert parts from its twin unexplained ({name})")
        explained += n_differ
        max_err = max(max_err, float((got - twin).abs().max()))

    by_path = {}
    for path, calls in kept.items():
        args = calls[min(4, len(calls) - 1)]
        for _ in range(3):
            kernels.scan_insert(*args)
        device_ms = graph_ms(lambda: kernels.scan_insert(*args))
        ms, plain_ms, chained = time_pair(lambda: kernels.scan_insert(*args),
                                          lambda: kernels.scan_insert_ref(*args), plain_calls=10)
        n_bytes, n_ops, folded = insert_work(args)
        b_ms, by = bound_ms(n_bytes, n_ops)
        gm = args[0]
        n_p = 1 if gm.cells.dim() == 3 else gm.cells.shape[0]
        side = min(args[6], gm.height, gm.width) if args[6] and n_p > 1 else gm.height
        rows = kernels.band_rows(n_p, side, side if args[6] and n_p > 1 else gm.width,
                                 gm.cells.shape[-1])
        print(f"scan_insert {path} {tuple(args[0].cells.shape)} window {args[6]} "
              f"{type(args[1]).__name__} {args[4].free_impl}, bands of {rows} rows: "
              f"{1e3 * device_ms:.2f} us device "
              f"(a CUDA graph of 50 calls), a call {ms:.4f} ms, chained {chained:.4f} ms; plain "
              f"twin {plain_ms:.4f} ms a call; bound {b_ms:.6f} ms by {by} ({n_bytes} B; {n_ops} "
              f"operations, {folded} cells folded) on {smi}; no single PyTorch call computes "
              f"it", flush=True)
        by_path[path] = {"device_ms": device_ms, "ms": ms, "plain_ms": plain_ms,
                         "chained_ms": chained, "bound_ms": b_ms, "bound_by": by,
                         "band_rows": rows}
    print(f"scan_insert: {len(cases)} cases equal to the ordered sums bit for bit; {explained} "
          f"cells differ from the twin, each in a run the card's index_put_ sums by a warp",
          flush=True)
    return {
        "name": "scan_insert", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/scan_insert.cu",
        "replaces": "slam_constructor_tpu/ops/raycast.py:89",
        "max_abs_err": max_err, "cases_bitwise_equal_to_ordered_sums": len(cases),
        "cells_differing_from_twin": explained, **by_path["tiny"], "by_path": by_path,
        "library_ms": None,
    }


def planes_call(args):
    """A ``scan_planes`` call's arguments (origins, h, w, scale, poses,
    scans, cfg, plane_of, n_planes), the tensors and the scans cloned."""
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    a = list(args) + [None] * (9 - len(args))
    origins, h, w, scale, poses, scans, cfg, plane_of, n_planes = a
    return (origins.clone(), h, w, scale, poses.clone(),
            LaserScan(scans.ranges.clone(), scans.bearings.clone(), scans.valid.clone()), cfg,
            None if plane_of is None else plane_of.clone(), n_planes)


def held_to_twin_planes(name, run):
    """A run of a full path (``run()`` returns its corrected trajectory)
    against one with ``scan_planes``' plain twin handed in (the card's
    ``index_put_``: the plain rasteriser), in which the kernel also runs on
    every call's arguments: the trajectories bit for bit, or, where they
    part, the cells in which kernel and twin differed, counted. Returns
    every call's arguments and what was found."""
    from slam_constructor_tpu_torch.ops import kernels

    traj = run()
    kernel, kept, cells, first = kernels.scan_planes, [], [0], [None]

    def stand_in(*args):
        twin = kernels.scan_planes_ref(*args)
        got = kernel(*args)
        differ = int(((got[0].view(torch.int32) != twin[0].view(torch.int32))
                      | (got[1].view(torch.int32) != twin[1].view(torch.int32))).sum())
        if differ and first[0] is None:
            first[0] = len(kept)
        cells[0] += differ
        kept.append(planes_call(args))
        return twin

    with handed_in(stand_in, "scan_planes"):
        twin_traj = run()
    apart = (bits(traj).reshape(traj.shape) != bits(twin_traj).reshape(traj.shape)).any(-1)
    part = int(apart.nonzero()[0]) if bool(apart.any()) else None
    print(f"{name} with scan_planes' plain twin handed in: {len(kept)} calls, {cells[0]} cells "
          f"differing from the kernel's (the first in call {first[0]}); the corrected trajectory "
          f"{'equal to the kernel path bit for bit' if part is None else f'parts at scan {part}'}"
          f"{'' if part is None else f' (max |diff| {float((traj - twin_traj).abs().max()):.3e} m)'}",
          flush=True)
    check(part is None or cells[0] > 0,
          f"{name}: the twin rasteriser's trajectory parts at scan {part} with no cell differing")
    return kept, {"calls": len(kept), "cells_differing_from_twin": cells[0],
                  "first_call_differing": first[0], "trajectory_parts_at_scan": part}


def planes_work(a):
    """(bytes, operations) of one ``scan_planes`` call on these inputs: the
    planes written once, the scans' rows, poses, origins and plane indices
    read once (the polar plane where there is one); the operations of the
    beams, of the DDA samples before each beam's free limit and of the
    occupied samples of the beams that carry evidence (the K3_* counts)."""
    origins, h, w, scale, poses, scans, cfg, plane_of, n_planes = a
    n = poses.shape[0]
    p = n if plane_of is None else n_planes
    r = scans.ranges.shape[-1]
    polar = cfg.free_impl == "polar"
    n_bytes = (8 * p * h * w + 9 * r * n + 12 * n + 4 * origins.numel()
               + (8 * n if plane_of is not None else 0) + (4 * p * h * w if polar else 0))
    ranges, valid = scans.ranges.reshape(-1, r), scans.valid.reshape(-1, r)
    traced = 0
    if not polar:
        n_s = cfg.n_free_samples(scale)
        t = (torch.arange(n_s, dtype=torch.float32, device=ranges.device) + 0.5) * (
            scale * cfg.step_fraction)
        traced = int(((t < (ranges - cfg.hole_width / 2.0)[..., None]) & valid[..., None]).sum())
    ep = int((valid & (ranges <= cfg.max_range)).sum())
    area = cfg.occupancy_estimator == "area"
    occ = ep * ((9 if area else 1) + (cfg.blur_samples if cfg.wall_blur else 0))
    n_ops = (K3_BEAM_OPS * n * r + K3_FREE_OPS * traced + K3_OCC_OPS * occ
             + (K3_AREA_OPS * 9 * ep if area else 0))
    return n_bytes, n_ops


def joint_refine_call(dev, fscans, fgt):
    """The ``scan_planes`` call of one ``joint_refine`` round over 8
    keyframes of the full sequence (K = 8 planes of 256^2, the tiny
    tracker's map and beam), run on the card."""
    from slam_constructor_tpu_torch.models import posegraph
    from slam_constructor_tpu_torch.ops import kernels

    cfg, tracking, st, gm = joint_refine_state(dev, fscans, fgt)
    recording, kept = [], []

    def keep(*args):
        kept.append(planes_call(args))
        return recording[0](*args)

    recording.append(kernels.scan_planes)
    with handed_in(keep, "scan_planes"):
        out = posegraph.joint_refine(cfg, tracking.cell_model, st, gm, tracking.beam, rounds=1)
    torch.cuda.synchronize()
    check(len(kept) == 1 and bool(torch.isfinite(out.kf_poses).all()),
          f"joint_refine: {len(kept)} scan_planes calls, or non-finite poses")
    return kept[0]


def big_plane_call(dev, fscans, fgt):
    """32 keyframes of the full sequence into one 256^2 plane: 32 x 360 x
    (1 + 4) = 57,600 occupied samples, more than the old sort held."""
    from slam_constructor_tpu_torch.ops import grid as gridlib

    tracking = full_config().tracking
    idx = torch.arange(32, device=dev) * 15
    origin = gridlib.make_grid_map(tracking.cell_model, MAP, MAP, tracking.map_scale,
                                   device=dev).origin
    return planes_call((origin, MAP, MAP, tracking.map_scale, fgt[idx], fscans[idx],
                        tracking.beam, torch.zeros(32, dtype=torch.int64, device=dev), 1))


def phase_scan_planes_kernel(dev, kept, fscans, fgt, smi):
    """K3 without the fold (``kernels.scan_planes``) on every 4th call kept
    from the full paths, a joint-refine round and a 57,600-sample plane:
    equal to ``scan_planes_ordered`` bit for bit, two launches the same
    bits, against the twin bit for bit but in the cells whose occupied run
    the card's ``index_put_`` sums in another order (32 or more). Then
    timed at the largest submap render, a regeneration group (the
    57,600-sample plane) and the joint-refine round. Returns the
    ``kernels`` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    cases = [(f"{path} call {i}", a) for path, calls in kept.items()
             for i, a in enumerate(calls) if i % PLANES_EVERY == 0]
    cases.append(("joint refine, one round of 8 keyframes", joint_refine_call(dev, fscans, fgt)))
    cases.append(("32 keyframes into one plane", big_plane_call(dev, fscans, fgt)))
    max_err, explained, most = 0.0, 0, 0
    for name, a in cases:
        before = kernels.launch_counts()["scan_planes"]
        got = kernels.scan_planes(*a)
        again = kernels.scan_planes(*a)
        want = kernels.scan_planes_ordered(*a)
        twin = kernels.scan_planes_ref(*a)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["scan_planes"] == before + 2,
              f"scan_planes did not count its launches ({name})")
        runs = kernels.scan_planes_runs(*a)
        samples = int(runs.sum(dim=(1, 2)).max())  # the most samples a plane holds
        most = max(most, samples)
        n_differ, excess, longest = 0, 0.0, 0
        # a value may part from the twin's only in a cell whose run of n >= 32
        # samples the card's index_put_ sums by a warp: by ~n 2^-24 relative
        tol = (runs.to(torch.float64) * 2.0**-24).clamp(min=1e-6)
        for g, g2, w_, t in zip(got, again, want, twin):
            check(g.shape == runs.shape and bool(torch.isfinite(g).all()),
                  f"scan_planes output malformed ({name})")
            check(torch.equal(bits(g), bits(w_)), f"scan_planes differs from the ordered sums "
                                                  f"({name}): {int((g != w_).sum())} cells")
            check(torch.equal(bits(g), bits(g2)), f"two launches differ ({name})")
            differ = g.view(torch.int32) != t.view(torch.int32)
            check(int((differ & (runs < 32)).sum()) == 0,
                  f"scan_planes parts from its twin in a cell with a short run ({name})")
            n_differ += int(differ.sum())
            if bool(differ.any()):
                longest = max(longest, int(runs[differ].max()))
            rel = (g - t).abs().to(torch.float64) / t.abs().to(torch.float64).clamp(min=1e-30)
            excess = max(excess, float((rel / tol).max()))
            max_err = max(max_err, float((g - t).abs().max()))
        print(f"scan_planes [{name}]: {a[4].shape[0]} scans into {tuple(got[0].shape)}, at most "
              f"{samples} occupied samples a plane: equal to the ordered sums bit for bit, two "
              f"launches equal; against the twin {n_differ} values differ, all in cells with 32 "
              f"or more occupied samples (the longest such run {longest}), each within "
              f"{excess:.3f} of its bound max(1e-6, n 2^-24) relative", flush=True)
        check(excess <= 1.0, f"scan_planes parts from its twin beyond n 2^-24 ({name})")
        explained += n_differ
    check(most >= 57600, f"no plane of 57,600 occupied samples or more was held ({most})")

    renders = [a for path, calls in kept.items() for a in calls if a[7] is not None and a[8] > 1]
    check(bool(renders), "the full paths rendered no submaps")
    shapes = {"render": max(renders, key=lambda a: a[4].shape[0]),
              "regeneration group": cases[-1][1], "joint refine": cases[-2][1]}
    timed = {}
    for shape, a in shapes.items():
        device_ms = graph_ms(lambda: kernels.scan_planes(*a))
        ms, plain_ms, chained = time_pair(lambda: kernels.scan_planes(*a),
                                          lambda: kernels.scan_planes_ref(*a), plain_calls=10)
        n_bytes, n_ops = planes_work(a)
        b_ms, by = bound_ms(n_bytes, n_ops)
        p = a[4].shape[0] if a[7] is None else a[8]
        rows = kernels.band_rows(p, a[1], a[2], 0)
        print(f"scan_planes {shape}: {a[4].shape[0]} scans into {p} planes of {a[1]}x{a[2]}, "
              f"bands of {rows} rows: {1e3 * device_ms:.2f} us device (a CUDA graph of 50 calls), "
              f"a call {ms:.4f} ms, chained {chained:.4f} ms; plain twin {plain_ms:.4f} ms a call; "
              f"bound {b_ms:.6f} ms by {by} ({n_bytes} B; {n_ops} operations) on {smi}; no single "
              f"PyTorch call computes it", flush=True)
        timed[shape] = {"device_ms": device_ms, "ms": ms, "plain_ms": plain_ms,
                        "chained_ms": chained, "bound_ms": b_ms, "bound_by": by,
                        "band_rows": rows}
    print(f"scan_planes: {len(cases)} cases equal to the ordered sums bit for bit; {explained} "
          f"values differ from the twin, each in a run the card's index_put_ sums by a warp",
          flush=True)
    return {
        "name": "scan_planes", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/scan_insert.cu",
        "replaces": "slam_constructor_tpu/models/posegraph.py:421",
        "max_abs_err": max_err, "cases_bitwise_equal_to_ordered_sums": len(cases),
        "values_differing_from_twin": explained, **timed["regeneration group"], "by_shape": timed,
        "library_ms": None,
    }


def phase_relocalize(dev):
    """Global relocalization on the card: the reference's test map (the
    cecum world mapped along the rectangle at 0.5 m steps into a 160^2 map,
    180 beams; built on the CPU, copied) and its three kidnapped poses,
    each within 0.12 m and 0.08 rad of the truth, one ``hill_climb``
    launch a call and nothing else of the package's kernels, no host sync
    before the pose; the FFT's pose (no refine) within a cell and a
    heading bin of the CPU's on the same inputs, the refined pose within
    1e-3."""
    from slam_constructor_tpu_torch.ops import cells, grid, raycast, relocalize, scoring
    from slam_constructor_tpu_torch.utils import datagen

    occ, origin, scale = datagen.cecum_world()
    bearings = datagen.default_bearings(180)
    model = cells.BayesAvgCell()
    gm = grid.make_grid_map(model, 160, 160, 0.1, device="cpu")
    for p in datagen.rectangle_trajectory(step=0.5):
        gm = raycast.insert_scan(gm, model, p, raycast.cast_rays(occ, origin, scale, p, bearings),
                                 raycast.BeamConfig(wall_blur=True))
    cpu_view = scoring.MapView.of(gm, model)
    card_view = scoring.MapView(occ=cpu_view.occ.to(dev), known=cpu_view.known.to(dev),
                                origin=cpu_view.origin.to(dev), scale=cpu_view.scale)
    cfg = relocalize.RelocalizeConfig(n_theta=64)
    fft_only = dataclasses.replace(cfg, refine_iterations=0)
    bin_ = 2 * cfg.half_theta / cfg.n_theta
    for pose in RELOCALIZE_KIDNAPPED:
        truth = torch.tensor(pose)
        scan = raycast.cast_rays(occ, origin, scale, truth, bearings)
        card_scan = scan.to(dev)
        relocalize.relocalize(card_view, card_scan, cfg)  # warm-up: the FFT's plans
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = relocalize.relocalize(card_view, card_scan, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        want = expect(hill_climb=1)
        check(launches == want, f"relocalize: launches {launches}, expected {want}")
        cpu = relocalize.relocalize(cpu_view, scan, cfg)
        fft_card = relocalize.relocalize(card_view, card_scan, fft_only).pose.cpu()
        fft_cpu = relocalize.relocalize(cpu_view, scan, fft_only).pose
        err = (res.pose.cpu().double() - truth.double())
        err[2] = math.remainder(float(err[2]), 2 * math.pi)
        d_fft = (fft_card - fft_cpu).abs()
        d_fft[2] = abs(math.remainder(float(fft_card[2] - fft_cpu[2]), 2 * math.pi))
        d_ref = float((res.pose.cpu() - cpu.pose).abs().max())
        print(f"relocalize {pose}: card pose {[round(float(v), 4) for v in res.pose]} (error "
              f"{float(err[:2].abs().max()):.4f} m, {abs(float(err[2])):.4f} rad; limits 0.12, "
              f"0.08), {1e3 * secs:.2f} ms a call with the sync check on (64 headings in one "
              f"batched FFT, a hill climb of 10 rounds); the FFT's pose {d_fft.tolist()} from the "
              f"CPU's (limits a cell, a heading bin), the refined pose {d_ref:.2e} from the CPU's",
              flush=True)
        check(float(err[:2].abs().max()) < 0.12 and abs(float(err[2])) < 0.08,
              f"relocalize {pose}: {err.tolist()} off the truth")
        check(float(d_fft[:2].max()) <= scale + 1e-5 and float(d_fft[2]) <= bin_ + 1e-5,
              f"relocalize {pose}: the card's FFT pose is more than a cell or a bin off the CPU's")
        check(d_ref <= 1e-3 or float(d_fft.max()) > 0, f"relocalize {pose}: card and CPU part")


# --- K3 over a block pool: the tiled map, the copy-on-write RBPF, growth -------


#: the pool kernels' plain versions, none of which a path through the card
#: may call: (module, name)
POOL_TWINS = (("kernels", "pool_insert_ref"), ("cow", "prepare_insert_ref"),
              ("blockmap", "prepare_tiles_ref"), ("kernels", "pool_touched_ref"),
              ("kernels", "pool_work_ref"), ("cow", "prepare_write"),
              ("blockmap", "allocate_tiles"))


@contextlib.contextmanager
def pool_twin_counted():
    """The calls of the pool kernels' plain versions (``POOL_TWINS``) while
    the block runs (a list with each call's name): none on a path through
    the card."""
    from slam_constructor_tpu_torch.ops import blockmap, cow, kernels

    modules = {"kernels": kernels, "cow": cow, "blockmap": blockmap}
    calls = []

    def counting(name, twin):
        def call(*args, **kwargs):
            calls.append(name)
            return twin(*args, **kwargs)
        return call

    with contextlib.ExitStack() as stack:
        for mod, name in POOL_TWINS:
            module = modules[mod]
            stack.enter_context(handed_in(counting(name, getattr(module, name)), name, module))
        yield calls


def cow_config(**kwargs):
    """bench.py's ``gmapping`` preset on the copy-on-write maps."""
    return dataclasses.replace(gmapping_config(), **COW_FIELDS, **kwargs)


def pool_call(args, kwargs):
    """A ``pool_insert`` call's arguments, the tensors cloned: (args,
    live), args (pool, tables, origin, scale, model, poses, scans, cfg,
    touched, q), live the ``refcnt`` or ``n_live`` keyword."""
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    names = ("pool", "tables", "origin", "scale", "model", "poses", "scans", "cfg", "touched", "q")
    a = dict(zip(names, args), **{k: v for k, v in kwargs.items() if k in names})
    live = {k: kwargs[k].clone() for k in ("refcnt", "n_live") if kwargs.get(k) is not None}
    sc = a["scans"]
    cloned = [a[k].clone() if isinstance(a.get(k), torch.Tensor) else a.get(k) for k in names]
    cloned[6] = LaserScan(sc.ranges.clone(), sc.bearings.clone(), sc.valid.clone())
    return tuple(cloned), live


PREP_NAMES = ("pool", "tables", "origin", "scale", "model", "poses", "scans", "cfg", "q", "refcnt",
              "overflow", "n_alloc", "k_max")


def prepare_call(args, kwargs):
    """A ``pool_prepare`` call's arguments (``PREP_NAMES``) as a dict, the
    tensors cloned: the state before the call."""
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    a = dict(zip(PREP_NAMES, args), **kwargs)
    out = {k: a[k].clone() if isinstance(a.get(k), torch.Tensor) else a.get(k)
           for k in PREP_NAMES}
    out["k_max"] = out["k_max"] or 0  # the tiled map's calls name none
    sc = a["scans"]
    out["scans"] = LaserScan(sc.ranges.clone(), sc.bearings.clone(), sc.valid.clone())
    return out


def live_slots(pool, live):
    """bool[N]: the slots a pool insert folds."""
    if "refcnt" in live:
        return live["refcnt"] > 0
    return torch.arange(pool.shape[0], device=pool.device) < live["n_live"]


def held_to_twin_pool(name, run, traj, every):
    """A run with the pool insert's plain twin handed in
    (``kernels.pool_insert_ref``, the card's ``index_put_``), in which the
    kernel also runs on a copy of every call's pool, against the path's
    trajectory ``traj`` through the kernel: bit for bit, or, where they
    part, an insert at or before that scan whose live blocks differed, and
    only in cells of 32 samples or more (trap c). Returns the kept insert
    calls (every ``every``-th), what was found, and the kept
    ``pool_prepare`` calls (every ``every``-th, the state before it)."""
    from slam_constructor_tpu_torch.ops import kernels

    kernel, kept, n, first, unexplained = kernels.pool_insert, [], [0], [None], [0]
    prepare, kept_prep, n_prep = kernels.pool_prepare, [], [0]

    def prep_keeping(*args, **kwargs):
        if n_prep[0] % every == 0:
            kept_prep.append(prepare_call(args, kwargs))
        n_prep[0] += 1
        return prepare(*args, **kwargs)

    def stand_in(pool, *args, **kwargs):
        call, live = pool_call((pool, *args), kwargs)
        got = pool.clone()
        kernel(got, *args, **kwargs)
        kwargs.pop("work", None)  # the twin makes its own owners
        kernels.pool_insert_ref(pool, *args, **kwargs)
        alive = live_slots(pool, live)
        if not torch.equal(bits(got[alive]), bits(pool[alive])):
            if first[0] is None:
                first[0] = n[0]
            runs = kernels.pool_insert_runs(*call[:4], *call[5:10], live.get("refcnt"))
            differ = (got != pool).any(-1) & alive[:, None, None]
            unexplained[0] += int((differ & (runs < 32)).sum())
        if n[0] % every == 0:
            kept.append((call, live))
        n[0] += 1
        return pool

    with handed_in(stand_in, "pool_insert"), handed_in(prep_keeping, "pool_prepare"):
        twin_traj = run()
    apart = (bits(traj).reshape(traj.shape) != bits(twin_traj).reshape(traj.shape)).any(-1)
    part = int(apart.nonzero()[0]) if bool(apart.any()) else None
    print(f"{name} with the pool insert's plain twin handed in: {n[0]} inserts, the first whose "
          f"live blocks differ from the kernel's {first[0]}, cells differing outside runs of 32 "
          f"samples or more: {unexplained[0]}; the trajectory "
          f"{'equal to the kernel path bit for bit' if part is None else f'parts at scan {part}'}",
          flush=True)
    check(unexplained[0] == 0, f"{name}: the pool insert parts from its twin outside long runs")
    check(part is None or (first[0] is not None and first[0] <= part),
          f"{name}: the twin's trajectory parts at scan {part} with no insert before it differing")
    return kept, {"inserts": n[0], "first_insert_differing_from_twin": first[0],
                  "trajectory_parts_at_scan": part}, kept_prep


def cow_maps_dense(e):
    """f32[P, H, W, C]: every particle's map of a copy-on-write engine,
    densified (a table's whole extent)."""
    from slam_constructor_tpu_torch.ops import cow

    st = e.state.gm
    th, tw = st.tables.shape[1:]
    centers = torch.zeros((st.n_particles, 2), device=st.pool.device)
    return cow.extract_window(st, e.cfg.cell_model, None, centers, th, tw).cells


def cow_bits(e):
    """The copy-on-write RBPF's genealogy, weights, tables, refcounts and
    live blocks, for comparing two runs."""
    st = e.state.gm
    return [*e.genealogy, e.state.log_weights, e.state.poses, st.tables, st.refcnt,
            st.pool[st.refcnt > 0]]


def compare_particle_maps(name, a, b):
    """Card against CPU: each particle's dense map; a cell that counted one
    DDA sample more or less (a sample on a cell's border) is counted, the
    rest within 1e-5."""
    moved = a[..., -1] != b[..., -1]
    belief = float((a[..., :-1] - b[..., :-1]).abs().amax(-1)[~moved].max())
    print(f"{name}: {int(moved.sum())} of {moved.numel()} cells counted one sample more or less "
          f"(at most {GM_MOVED_CELLS}), max|belief diff| elsewhere {belief:.3e} (tol 1e-5)",
          flush=True)
    check(int(moved.sum()) <= GM_MOVED_CELLS and belief <= 1e-5, f"{name}: maps disagree")


def rbpf_draws(cfg, n, seed=5):
    """``n`` steps of draws made with numpy: the Monte-Carlo normals only
    where a Monte-Carlo match (or a refine after another match) runs."""
    from slam_constructor_tpu_torch.models import gmapping

    p = cfg.n_particles
    rng = np.random.default_rng(seed)

    def normals(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def mc(mcfg):
        return normals(n, p, mcfg.rounds, mcfg.batch, 3)

    return gmapping.Draws(
        proposal=normals(n, p, 3),
        match=mc(cfg.matcher_cfg) if cfg.matcher == "monte_carlo" else None,
        u0=torch.from_numpy(rng.uniform(0, 1 / p, n).astype(np.float32)),
        refine=mc(cfg.refine_cfg) if (cfg.refine_matcher == "monte_carlo"
                                      and cfg.matcher != "monte_carlo") else None)


def phase_gmapping_cow_path(scans, odom, gt, odo_ate, smi):
    """The RBPF on the copy-on-write maps at bench.py's gmapping width (512
    scans, sync check on): launches, overflow, distinct blocks, the pool's
    bytes, the winner's ATE against the reference's keys, two runs equal;
    then once more with the pool insert's twin handed in. Returns the
    launches, the kept insert calls and the twin's findings."""
    from slam_constructor_tpu_torch.ops import cow
    from slam_constructor_tpu_torch.utils import evaluate

    cfg = cow_config()
    run_gmapping_path(cfg, scans[:8], odom[:8], gt, 0)  # warm-up
    with pool_twin_counted() as twin_calls:
        reset_launches()
        e, traj, neffs, secs = run_gmapping_path(cfg, scans, odom, gt, "error")
        launches = read_launches()
    want = expect(mc_match_batched=N_SCANS, pool_prepare=N_SCANS, pool_insert=N_SCANS,
                  prng_draws=N_SCANS)
    st = e.state.gm
    distinct = int(cow.distinct_blocks(st))
    pool_mb = st.pool.numel() * 4 / 1e6
    dense_mb = cfg.n_particles * MAP * MAP * st.pool.shape[-1] * 4 / 1e6
    print(f"gmapping cow path ({cfg.n_particles} particles, blocks of {cfg.tile_block}, "
          f"{cfg.window_tiles} x {cfg.window_tiles} tiles matched, {st.capacity} blocks): "
          f"{N_SCANS} scans in {secs:.3f} s = {N_SCANS / secs:.1f} scans/s on {smi}, sync check "
          f"on, no host sync; launches {launches} (expected {want}); the plain versions called "
          f"{len(twin_calls)} times; overflow latched: {bool(st.overflow)}; {distinct} distinct "
          f"blocks at the end; the pool {pool_mb:.1f} MB against the dense path's 30 maps "
          f"{dense_mb:.1f} MB", flush=True)
    check(launches == want, f"gmapping cow: launches {launches}, expected {want}")
    check_libm("gmapping cow", expect_libm("gmapping"))
    check(not twin_calls, f"gmapping cow: the pool's plain versions ran on the card's path: "
                          f"{sorted(set(twin_calls))}")
    winner = e.winner_trajectory()
    check(bool(torch.isfinite(winner).all()) and bool(torch.isfinite(e.occupancy).all())
          and e.occupancy.shape == (MAP, MAP), "gmapping cow: non-finite poses or map")
    ate = float(evaluate.ate(winner, gt, align=False))
    limit = max(GMAPPING_COW_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping cow path: winner ATE {ate:.4f} m (limit: the reference's worst key + margin "
          f"{limit:.4f}; its five keys {min(GMAPPING_COW_REFERENCE_ATE_BY_KEY):.4f}-"
          f"{max(GMAPPING_COW_REFERENCE_ATE_BY_KEY):.4f}), online "
          f"{float(evaluate.ate(traj, gt, align=False)):.4f} m, odometry {odo_ate:.4f} m; min "
          f"Neff {float(neffs.min()):.2f}", flush=True)
    check(ate <= limit, f"gmapping cow: winner ATE {ate} above the reference's worst key + margin")
    e2, traj2, _, secs2 = run_gmapping_path(cfg, scans, odom, gt, 0)
    same = torch.equal(traj2, traj) and all(
        torch.equal(a, b) for a, b in zip(cow_bits(e), cow_bits(e2)))
    print(f"gmapping cow repeatability: trajectory, genealogy, weights, tables and live blocks of "
          f"two runs equal: {same}; second run, sync check off: {N_SCANS / secs2:.1f} scans/s on "
          f"{smi}",
          flush=True)
    check(same, "gmapping cow: two runs differ")
    kept, found, kept_prep = held_to_twin_pool(
        "gmapping cow", lambda: run_gmapping_path(cfg, scans, odom, gt, 0)[1], traj, POOL_EVERY)
    return launches, kept, found, kept_prep, {"scans_per_sec": N_SCANS / secs, "winner_ate_m": ate,
                                   "overflow": bool(st.overflow), "distinct_blocks": distinct,
                                   "pool_mb": pool_mb, "dense_maps_mb": dense_mb}


def phase_gmapping_cow_quality(dev, smi):
    """The copy-on-write RBPF over the reference's two-lap quality sequence:
    the winner's ATE within the reference's worst key + margin."""
    from slam_constructor_tpu_torch.utils import evaluate

    scans, odom, gt = gmapping_quality_sequence(dev)
    with pool_twin_counted() as twin_calls:
        reset_launches()
        e, traj, _, secs = run_gmapping_path(cow_config(), scans, odom, gt, 0)
        launches = read_launches()
    n = len(gt)
    want = expect(mc_match_batched=n, pool_prepare=n, pool_insert=n, prng_draws=n)
    check(launches == want and not twin_calls,
          f"gmapping cow 2 laps: launches {launches}, expected {want}; plain versions called "
          f"{sorted(set(twin_calls))}")
    ate = float(evaluate.ate(e.winner_trajectory(), gt, align=False))
    odo = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    limit = max(GMAPPING_COW_2LAP_REFERENCE_ATE_BY_KEY) + GMAPPING_ATE_MARGIN
    print(f"gmapping cow, the reference's quality sequence ({len(gt)} scans, two laps): winner "
          f"ATE {ate:.4f} m (limit: the reference's worst key + margin {limit:.4f}; odometry "
          f"{odo:.4f}), {len(gt) / secs:.1f} scans/s on {smi}; overflow "
          f"{bool(e.state.gm.overflow)}; launches {launches}, no plain version called",
          flush=True)
    check(ate <= limit, f"gmapping cow 2 laps: winner ATE {ate} above {limit}")


def phase_gmapping_cow_card_vs_cpu(dev, scans, odom, gt, smi, n=16):
    """The first ``n`` scans of the copy-on-write path on the card and on
    the CPU with the same draws; then a ``handle_scan`` run from 64 blocks
    that grows the pool, card against CPU."""
    from slam_constructor_tpu_torch.models import gmapping

    cfg = cow_config()
    draws = rbpf_draws(cfg, n)
    runs = []
    for d in (None, "cpu"):
        on = torch.device(d) if d else dev
        with pool_twin_counted() as twin_calls:
            reset_launches()
            e, _, _, _ = run_gmapping_path(cfg, scans[:n].to(on), odom[:n].to(on), gt.to(on), 0,
                                           draws=draws, device=d)
            launches = read_launches()
        if d is None:  # the card: the two pool kernels a step, no plain version
            want = expect(mc_match_batched=n, pool_prepare=n, pool_insert=n, prng_draws=n)
            check(launches == want and not twin_calls,
                  f"gmapping cow card vs CPU: launches {launches}, expected {want}; plain "
                  f"versions called {sorted(set(twin_calls))}")
        runs.append((e, [t.cpu() for t in cow_bits(e)[:4]], cow_maps_dense(e).cpu()))
    (_, (pa, aa, la, qa), ma), (_, (pb, ab, lb, qb), mb) = runs
    diff = float((pa - pb).abs().max())
    print(f"gmapping cow card vs CPU, {n} scans, the same draws: max|pose diff| {diff:.3e} (tol "
          f"1e-4), ancestors equal: {torch.equal(aa, ab)}, max|log-weight diff| "
          f"{float((la - lb).abs().max()):.3e} (tol 1e-4)", flush=True)
    check(diff <= 1e-4 and torch.equal(aa, ab) and float((la - lb).abs().max()) <= 1e-4,
          "gmapping cow card vs CPU: trajectories or weights disagree")
    compare_particle_maps("gmapping cow card vs CPU", ma, mb)

    grow = dataclasses.replace(cfg, tile_capacity=64)
    draws = rbpf_draws(grow, COW_GROW_SCANS, seed=6)
    runs = []
    for d in (dev, torch.device("cpu")):
        e = gmapping.GMappingEngine(grow, device=d, seed=0)
        e.state.poses = gt[0].to(d).expand(grow.n_particles, 3).clone()
        t0 = time.perf_counter()
        for i in range(COW_GROW_SCANS):
            e.handle_scan(scans[i], odom[i], draws[i])
        traj = torch.stack(e.trajectory).cpu()
        runs.append((e.state.gm.capacity, traj, cow_maps_dense(e).cpu(), time.perf_counter() - t0))
    (ca, ta, ma, sa), (cb, tb, mb, _) = runs
    diff = float((ta - tb).abs().max())
    print(f"gmapping cow handle_scan from 64 blocks, {COW_GROW_SCANS} scans (the latch read every "
          f"32): the pool grew to {ca} blocks on the card, {cb} on the CPU; max|pose diff| "
          f"{diff:.3e} (tol 1e-4); {COW_GROW_SCANS / sa:.1f} scans/s on {smi}", flush=True)
    check(ca > 64 and ca == cb and diff <= 1e-4, "gmapping cow growth: card and CPU disagree")
    compare_particle_maps("gmapping cow growth card vs CPU", ma, mb)


def phase_auto_grow(dev, scans, odom, gt, smi):
    """tiny and viny_m3rsm from a 96^2 map through ``handle_scan`` with
    ``auto_grow``: the map grows, the pyramid is rebuilt on growth (one
    ``m3rsm_pyramid`` launch a scan, its refresh, and one more a growth),
    and the final shape, origin
    and poses equal the CPU run's (poses within 1e-4)."""
    from slam_constructor_tpu_torch.models import engine, tiny, viny

    out = {}
    m3 = viny.viny_m3rsm_config(map_size=GROW_MAP)
    # the whole map scored: a grown map's sides are no multiples of 2^levels,
    # which the windowed search refuses (the reference's too)
    m3 = dataclasses.replace(m3, matcher_cfg=dataclasses.replace(m3.matcher_cfg, window=0))
    for name, cfg in (("tiny", tiny.tiny_config(map_size=GROW_MAP)), ("viny_m3rsm", m3)):
        noise = None
        if cfg.matcher == "monte_carlo":
            noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
                (GROW_SCANS, cfg.matcher_cfg.rounds, cfg.matcher_cfg.batch, 3)).astype(np.float32))
        runs = []
        for d in (dev, torch.device("cpu")):
            e = engine.Engine(cfg, device=d, seed=0)
            e.auto_grow = True
            e.state.pose = gt[0].to(d).clone()
            reset_launches()
            shapes, t0 = [tuple(e.state.gm.cells.shape)], time.perf_counter()
            for i in range(GROW_SCANS):
                e.handle_scan(scans[i], odom[i], noise=None if noise is None else noise[i])
                if tuple(e.state.gm.cells.shape) != shapes[-1]:
                    shapes.append(tuple(e.state.gm.cells.shape))
            if d.type == "cuda":
                torch.cuda.synchronize()
            runs.append((torch.stack(e.trajectory).cpu(), shapes, e.state.gm.origin.cpu(),
                         read_launches(), time.perf_counter() - t0))
        (ta, sha, oa, la, secs), (tb, shb, ob, _, _) = runs
        diff = float((ta - tb).abs().max())
        grown = len(sha) - 1
        pyr = la["m3rsm_pyramid"]
        print(f"auto_grow {name} from {GROW_MAP}^2, {GROW_SCANS} scans through handle_scan: "
              f"shapes {sha} on the card, {shb} on the CPU; origins equal: "
              f"{torch.equal(oa, ob)}; max|pose diff| {diff:.3e} (tol 1e-4); m3rsm_pyramid "
              f"launches {pyr}; {GROW_SCANS / secs:.1f} scans/s on {smi} (a bool read a scan)",
              flush=True)
        check(grown >= 1 and sha == shb and torch.equal(oa, ob) and diff <= 1e-4,
              f"auto_grow {name}: the card and the CPU disagree, or the map did not grow")
        if name == "viny_m3rsm":  # counted from after the engine's own build
            check(pyr == GROW_SCANS + grown,
                  f"auto_grow {name}: {pyr} pyramid launches, expected {GROW_SCANS + grown}")
        out[name] = {"growths": grown, "final_shape": sha[-1]}
    return out


def pool_cases(kept):
    """(name, args, live) of the kept pool inserts and the edge cases: a
    beam along a tile boundary, a particle at the table's corner (samples
    off it), no valid beam, a pool exhausted by the tiled map, shared
    untouched blocks inside two particles' regions."""
    from slam_constructor_tpu_torch.ops import blockmap, cow, kernels
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    cases = [(f"{path} insert {i * POOL_EVERY}", a, live) for path, calls in kept.items()
             for i, (a, live) in enumerate(calls)]
    (pool, tables, origin, scale, model, poses, scans, cfg, _, q), live = kept["gmapping cow"][
        min(4, len(kept["gmapping cow"]) - 1)]
    st = cow.CowBlockMaps(pool=pool.clone(), tables=tables.clone(), refcnt=live["refcnt"].clone(),
                          origin=origin, scale=scale, block=pool.shape[1],
                          overflow=torch.zeros((), dtype=torch.bool, device=pool.device))
    poses = poses.clone()
    poses[0, :2] = origin + 3 * st.block * scale  # a tile corner: beams along tile boundaries
    poses[0, 2] = 0.0
    poses[1, :2] = origin + 0.4  # the table's corner
    valid = scans.valid.clone()
    valid[2] = False
    scans = LaserScan(scans.ranges, scans.bearings, valid)
    touched = cow.touched_tiles(st, poses, scans, cfg)
    st = cow.prepare_write(st, model, touched)
    shared = int((st.refcnt > 1).sum())
    cases.append((f"gmapping cow state: a beam along tile boundaries, a particle at the table's "
                  f"corner, one without a valid beam, {shared} shared untouched blocks",
                  (st.pool, st.tables, origin, scale, model, poses, scans, cfg, touched, None),
                  {"refcnt": st.refcnt}))
    (pool, tables, origin, scale, model, poses, scans, cfg, _, q), live = kept["cli mit_stata"][-1]
    bm = blockmap.make_block_map(model, *tables.shape[1:], 8, block=pool.shape[1], scale=scale,
                                 device=pool.device)
    touched = kernels.pool_touched(tuple(tables.shape[1:]), pool.shape[1], origin, scale, poses,
                                   scans, cfg, q)
    bm = blockmap.allocate_tiles(bm, touched[0])
    cases.append((f"mit_stata scan into a pool of 8 blocks ({int(bm.n_alloc)} asked for)",
                  (bm.pool, bm.table[None], origin, scale, model, poses, scans, cfg, touched, q),
                  {"n_live": bm.n_alloc}))
    return cases


def pool_work(args, live):
    """(bytes, operations, live slots, the marks' bytes and operations) of
    one pool insert on these inputs: the live blocks read and written once,
    the scans' rows, poses, tables, touched marks and owners read once; the
    operations of the beams, the DDA samples before each beam's free limit,
    the occupied samples and the folded cells (the K3_* counts). The marks
    (``pool_touched``) read the scans and poses and write a byte an entry;
    their operations are :func:`marks_ops`."""
    pool, tables, origin, scale, model, poses, scans, cfg, touched, q = args
    alive = int(live_slots(pool, live).sum())
    cells_a_block = pool.shape[1] * pool.shape[2]
    p, r = poses.shape[0], scans.ranges.shape[-1]
    rows = 1 if scans.ranges.stride(0) == 0 else p
    n_bytes = (2 * 4 * alive * cells_a_block * pool.shape[3] + 9 * r * rows + 12 * p
               + 5 * tables.numel() + 4 * pool.shape[0])
    ranges, valid = scans.ranges.reshape(-1, r), scans.valid.reshape(-1, r)
    n_s = cfg.n_free_samples(scale)
    t = (torch.arange(n_s, dtype=torch.float32, device=ranges.device) + 0.5) * (
        scale * cfg.step_fraction)
    traced = int(((t < (ranges - cfg.hole_width / 2.0)[..., None]) & valid[..., None]).sum())
    traced *= p // ranges.shape[0]
    ep = int((valid & (ranges <= cfg.max_range)).sum()) * (p // ranges.shape[0])
    area = cfg.occupancy_estimator == "area"
    occ = ep * ((9 if area else 1) + (cfg.blur_samples if cfg.wall_blur else 0))
    n_ops = (K3_BEAM_OPS * p * r + K3_FREE_OPS * traced + K3_OCC_OPS * occ
             + (K3_AREA_OPS * 9 * ep if area else 0)
             + K3_FOLD_OPS[type(model).__name__] * alive * cells_a_block)
    touch_bytes = 9 * r * rows + 12 * p + tables.numel()
    touch_ops = marks_ops(origin, scale, pool.shape[1], tables.shape[1:], poses, scans, cfg, q)
    return n_bytes, n_ops, alive, touch_bytes, touch_ops


def marks_ops(origin, scale, block, tiles, poses, scans, cfg, q):
    """The operations of the prepare kernel's marks on these inputs: each
    beam's set-up (K3_BEAM_OPS), each occupied sample (K3_OCC_OPS), and a
    sample evaluated (K3_FREE_OPS) for each mark of the free trace that the
    crossing search finds: the first free sample and each tile boundary
    that the row or the column passes between the first and the last free
    sample on the table (``csrc/scan_insert.cu``'s ``boundaries``)."""
    p, r = poses.shape[0], scans.ranges.shape[-1]
    th, tw = tiles
    ranges, valid = scans.ranges.expand(p, r), scans.valid.expand(p, r)
    ep = int((valid & (ranges <= cfg.max_range)).sum())
    occ = ep * ((9 if cfg.occupancy_estimator == "area" else 1)
                + (cfg.blur_samples if cfg.wall_blur else 0))
    step = scale * cfg.step_fraction
    t = (torch.arange(cfg.n_free_samples(scale), dtype=torch.float32, device=ranges.device)
         + 0.5) * step
    n = ((t < (ranges - cfg.hole_width / 2.0)[..., None]).sum(-1) * valid).to(torch.float32)
    if q is not None and not float(q) > 0:
        n = torch.zeros_like(n)
    ang = poses[:, 2:3] + scans.bearings.expand(p, r)
    t0, t1 = 0.5 * step, (n - 0.5) * step

    def passed(p0, d, o, n_bk):
        a = torch.floor((p0 + t0 * d - o) / scale)
        z = torch.floor((p0 + t1 * d - o) / scale)
        lo, hi, extent = torch.minimum(a, z), torch.maximum(a, z), n_bk * block
        m_lo = torch.where(lo < 0, 0.0, torch.where(lo >= extent, n_bk + 1.0,
                                                     torch.floor(lo / block) + 1))
        m_hi = torch.where(hi < 0, -1.0, torch.where(hi >= extent, float(n_bk),
                                                      torch.floor(hi / block)))
        return (m_hi - m_lo + 1).clamp(min=0)

    marks = 1 + passed(poses[:, 1:2], torch.sin(ang), origin[1], th) + passed(
        poses[:, 0:1], torch.cos(ang), origin[0], tw)
    free = int(torch.nan_to_num(torch.where(n > 0, marks, 0.0)).sum())
    return K3_BEAM_OPS * p * r + K3_OCC_OPS * occ + K3_FREE_OPS * free


def prepare_state(c):
    """A kept ``pool_prepare`` call's arguments with its state (pool,
    tables, refcounts, latch, n_alloc) cloned, for one more call."""
    return {k: v.clone() if k in ("pool", "tables", "refcnt", "overflow", "n_alloc")
            and v is not None else v for k, v in c.items()}


def prepare_cases(prep_kept):
    """(name, call) of the kept ``pool_prepare`` calls and the edge cases:
    on a copy-on-write state a pose on a tile corner (beams along tile
    boundaries), one at the table's corner, a NaN pose, a scan without a
    valid beam and one whose free limits fall on samples; the same with a
    budget of 7 new blocks; the state resampled to one ancestor (every
    touched tile copied); the state grown to 16,384 blocks (too large for
    block 0's shared memory: the state worked on in device memory, as a
    pool that ``GMappingEngine`` grew four times); the first step (an empty
    pool) and an empty pool of 64 blocks (trap o), q = 0; the tiled map's
    scan into an exhausted pool of 8 blocks and with q = 0."""
    from slam_constructor_tpu_torch.ops import blockmap, cow
    from slam_constructor_tpu_torch.ops.scan import LaserScan

    cases = [(f"{path} prepare {i * POOL_EVERY}", c) for path, calls in prep_kept.items()
             for i, c in enumerate(calls)]
    calls = prep_kept["gmapping cow"]
    base = prepare_state(calls[min(4, len(calls) - 1)])
    origin, scale, cfg = base["origin"], base["scale"], base["cfg"]
    b = base["pool"].shape[1]
    poses, sc = base["poses"].clone(), base["scans"]
    poses[0, :2] = origin + 3 * b * scale  # a tile corner: beams along tile boundaries
    poses[0, 2] = 0.0
    poses[1, :2] = origin + 0.4  # the table's corner
    poses[2, 0] = float("nan")
    ranges, valid = sc.ranges.clone(), sc.valid.clone()
    valid[3] = False
    step = np.float32(scale * cfg.step_fraction)
    k = torch.arange(ranges.shape[-1], device=ranges.device) % 97 + 1
    ranges[4] = (k.to(torch.float32) + 0.5) * float(step) + np.float32(cfg.hole_width / 2.0)
    edge = dict(base, poses=poses, scans=LaserScan(ranges, sc.bearings.clone(), valid))
    cases.append(("gmapping cow state: a tile corner, the table's corner, a NaN pose, no valid "
                  "beam, free limits on samples", edge))
    cases.append(("gmapping cow state, a budget of 7 new blocks",
                  dict(prepare_state(edge), k_max=7)))
    one = prepare_state(base)  # resampled to particle 0: every touched tile is shared
    one["tables"] = one["tables"][:1].expand_as(one["tables"]).contiguous()
    one["refcnt"] = cow._counts(one["tables"].reshape(-1), one["pool"].shape[0])
    cases.append((COPIES_CASE, one))
    st = cow.grow_pool(cow.CowBlockMaps(
        pool=base["pool"], tables=base["tables"], refcnt=base["refcnt"], origin=origin,
        scale=scale, block=b, overflow=base["overflow"]), base["model"], 16384)
    cases.append(("gmapping cow state grown to 16,384 blocks (block 0 uncached)", dict(
        prepare_state(base), pool=st.pool, refcnt=st.refcnt, overflow=st.overflow)))
    p, th, tw = base["tables"].shape
    for cap, q in ((base["pool"].shape[0], None), (64, None),
                   (base["pool"].shape[0], torch.zeros((), device=poses.device))):
        st = cow.make_cow_maps(base["model"], p, th, tw, cap, block=b, scale=scale,
                               device=poses.device)
        name = ("the first step" if cap > 64 else "the first step into 64 blocks (trap o)") + (
            ", q = 0" if q is not None else "")
        cases.append((f"gmapping cow {name}", dict(
            base, pool=st.pool, tables=st.tables, refcnt=st.refcnt, overflow=st.overflow,
            origin=st.origin, q=q)))
    tcalls = prep_kept["cli mit_stata"]
    t = prepare_state(tcalls[-1])
    for cap, q in ((8, t["q"]), (t["pool"].shape[0], torch.zeros((), device=poses.device))):
        bm = blockmap.make_block_map(t["model"], *t["tables"].shape[1:], cap,
                                     block=t["pool"].shape[1], scale=t["scale"],
                                     device=poses.device)
        cases.append((f"mit_stata scan into an empty pool of {cap} blocks"
                      + (", q = 0" if q is not None and float(q) == 0.0 else ""),
                      dict(t, pool=bm.pool, tables=bm.table[None], n_alloc=bm.n_alloc,
                           origin=bm.origin, q=q)))
    return cases


#: the prepare case whose new blocks are copies, timed beside the kept calls
COPIES_CASE = "gmapping cow state resampled to one ancestor (copies)"


def prepare_plain(c):
    """The plain version of the ``pool_prepare`` call ``c`` on its tensors,
    in place: ``cow.prepare_insert_ref`` or ``blockmap.prepare_tiles_ref``."""
    from slam_constructor_tpu_torch.ops import blockmap, cow

    b = c["pool"].shape[1]
    if c["refcnt"] is not None:
        st = cow.CowBlockMaps(pool=c["pool"], tables=c["tables"], refcnt=c["refcnt"],
                              origin=c["origin"], scale=c["scale"], block=b,
                              overflow=c["overflow"])
        return cow.prepare_insert_ref(st, c["model"], c["poses"], c["scans"], c["cfg"], c["q"],
                                      c["k_max"])
    bm = blockmap.BlockMap(pool=c["pool"], table=c["tables"][0], n_alloc=c["n_alloc"],
                           origin=c["origin"], scale=c["scale"], block=b)
    return blockmap.prepare_tiles_ref(bm, c["poses"], c["scans"], c["cfg"], c["q"])


def work_src(work):
    """i32: the copy sources of the prepare's new blocks (-1: a reset)."""
    return work.src[:int(work.buf[4])]


def prepare_work(c, work, touched):
    """(bytes, operations) of one prepare on these inputs: the scans' rows
    and poses read once, the tables and refcounts (or n_alloc) read and
    written, the marks, owners and items written, each new block's source
    read and the block written; the marks' operations (:func:`marks_ops`)."""
    pool, scans, cfg = c["pool"], c["scans"], c["cfg"]
    p, r = c["poses"].shape[0], scans.ranges.shape[-1]
    rows = 1 if scans.ranges.stride(0) == 0 else p
    block = pool.shape[1] * pool.shape[2] * pool.shape[3] * 4
    src = work_src(work)
    n_bytes = (9 * r * rows + 12 * p + 8 * touched.numel() + touched.numel()
               + (8 * pool.shape[0] if c["refcnt"] is not None else 8) + 4 * pool.shape[0]
               + 4 * int(work.buf[2]) + block * (int(src.numel()) + int((src >= 0).sum())))
    return n_bytes, marks_ops(c["origin"], c["scale"], pool.shape[1], touched.shape[1:],
                              c["poses"], scans, cfg, c["q"])


def phase_pool_prepare(prep_kept, smi):
    """``pool_prepare`` on the calls kept from the mit_stata and the
    copy-on-write runs and on the edge cases (:func:`prepare_cases`):
    against its plain version (:func:`prepare_plain`: ``pool_touched_ref``,
    then ``cow.prepare_write`` or ``blockmap.allocate_tiles``, then
    ``pool_work_ref``) bit for bit: marks, tables, refcounts, latch or
    n_alloc, the whole pool (the copied and reset blocks), owners and work
    list; then ``pool_insert`` from its work list (the robot's tile in
    bands) against ``pool_insert_ordered`` on every live slot. Then the
    prepare timed at each path's shape and on the copy-on-write state
    resampled to one ancestor (new blocks that are copies). Returns its
    ``kernels`` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import kernels

    cases = prepare_cases(prep_kept)
    for name, c in cases:
        got, want = prepare_state(c), prepare_state(c)
        before = kernels.launch_counts()["pool_prepare"]
        touched, work = kernels.pool_prepare(**got)
        t_want, w_want = prepare_plain(want)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["pool_prepare"] == before + 1,
              f"pool_prepare did not count its launch ({name})")
        cow_pool = got["refcnt"] is not None
        state = ("tables", "refcnt", "overflow") if cow_pool else ("tables", "n_alloc")
        count = int(work.buf[2])
        same = {"marks": torch.equal(touched, t_want),
                **{k: torch.equal(got[k], want[k]) for k in state},
                "pool": torch.equal(bits(got["pool"]), bits(want["pool"])),
                "owners": torch.equal(work.owner, w_want.owner),
                "header": torch.equal(work.buf[2:5], w_want.buf[2:5]),
                "items": torch.equal(work.items[:count], w_want.items[:count])}
        check(all(same.values()), f"pool_prepare differs from its plain version ({name}): "
                                  f"{[k for k, v in same.items() if not v]}")
        live = {"refcnt": got["refcnt"]} if cow_pool else {"n_live": got["n_alloc"]}
        args = (got["tables"], got["origin"], got["scale"], got["model"], got["poses"],
                got["scans"], got["cfg"], touched, got["q"])
        ins, ordered = got["pool"].clone(), got["pool"].clone()
        kernels.pool_insert(ins, *args, **live, work=work)
        kernels.pool_insert_ordered(ordered, *args, **live)
        alive = live_slots(ins, live)
        check(torch.equal(bits(ins[alive]), bits(ordered[alive]))
              and torch.equal(bits(ins[~alive]), bits(got["pool"][~alive])),
              f"pool_insert from the prepare's list differs from the ordered sums ({name})")
        banded = int(((work.items[:count] & 15) < work.n_bands).sum()) // work.n_bands
        print(f"pool_prepare [{name}]: {int(touched.sum())} tiles touched, "
              f"{int(work.buf[4])} new blocks ({int((work_src(work) >= 0).sum())} copies), "
              f"{count} items ({banded} tiles in {work.n_bands} bands), latch "
              f"{bool(got['overflow']) if cow_pool else int(got['n_alloc'])}: marks, tables, "
              f"refcounts, latch, pool, owners and list equal to the plain version bit for "
              f"bit; the insert from the list equal to the ordered sums on every live slot",
              flush=True)

    timed = [(path, prepare_state(calls[min(4, len(calls) - 1)]))
             for path, calls in prep_kept.items()]
    timed.append(("gmapping cow copies", prepare_state(dict(cases)[COPIES_CASE])))
    by_path = {}
    for path, c in timed:
        saved = {k: c[k].clone() for k in ("tables", "refcnt", "overflow", "n_alloc")
                 if c[k] is not None}

        def restore(c=c, saved=saved):
            for k, v in saved.items():
                c[k].copy_(v)

        def prep(c=c, restore=restore):
            restore()
            kernels.pool_prepare(**c)

        def plain(c=c, restore=restore):
            restore()
            prepare_plain(c)

        device_ms = graph_ms(prep) - graph_ms(restore)
        ms, plain_ms, chained = time_pair(prep, plain, plain_calls=10)
        r_ms, _, r_chained = time_pair(restore, restore, plain_calls=10)
        restore()
        touched, work = kernels.pool_prepare(**c)
        n_bytes, n_ops = prepare_work(c, work, touched)
        b_ms, by = bound_ms(n_bytes, n_ops)
        new = int(work.buf[4])
        copies = int((work_src(work) >= 0).sum())
        print(f"pool_prepare {path} {tuple(c['pool'].shape)} {c['tables'].shape[0]} tables, "
              f"{new} new blocks ({copies} copies): {1e3 * device_ms:.2f} us device (a CUDA "
              f"graph of 50 calls less its state's restore), a call {ms - r_ms:.4f} ms, chained "
              f"{chained - r_chained:.4f} ms (with the restore {ms:.4f} / {chained:.4f}); plain "
              f"version {plain_ms - r_ms:.4f} ms a call; bound {b_ms:.6f} ms by {by} "
              f"({n_bytes} B; {n_ops} operations) on {smi}; no single PyTorch call computes it",
              flush=True)
        by_path[path] = {"device_ms": device_ms, "ms": ms - r_ms, "plain_ms": plain_ms - r_ms,
                         "chained_ms": chained - r_chained, "bound_ms": b_ms, "bound_by": by,
                         "new_blocks": new, "copies": copies}
    return {"name": "pool_prepare", "route": "cuda",
            "source": "slam_constructor_tpu_torch/csrc/scan_insert.cu",
            "replaces": "slam_constructor_tpu/ops/cow.py:82", "max_abs_err": 0.0,
            "cases_bitwise_equal_to_plain": len(cases), **by_path["gmapping cow"],
            "by_path": by_path, "library_ms": None}


def phase_pool_kernels(kept, prep_kept, smi):
    """The pool insert (``kernels.pool_insert``) on the inserts kept from
    the mit_stata CLI run and the copy-on-write run, and on edge cases:
    equal to the ordered host sums bit for bit on every live slot, two
    launches the same bits, dead slots untouched, the twin within 2e-6
    but in cells of 32 samples or more; the marks (``pool_touched``) equal
    to their twin. Then both timed at each path's shape, the insert from
    its work list; then :func:`phase_pool_prepare`. Returns the three
    ``kernels`` entries without the launch counts."""
    from slam_constructor_tpu_torch.ops import kernels

    cases = pool_cases(kept)
    max_err, max_touch_err, differing = 0.0, 0, 0
    for name, args, live in cases:
        pool, tables, origin, scale, model, poses, scans, cfg, touched, q = args
        marks = kernels.pool_touched(tuple(tables.shape[1:]), pool.shape[1], origin, scale,
                                     poses, scans, cfg, q)
        marks_twin = kernels.pool_touched_ref(tuple(tables.shape[1:]), pool.shape[1], origin,
                                              scale, poses, scans, cfg, q)
        check(torch.equal(marks, marks_twin) and torch.equal(marks, touched),
              f"pool_touched differs from its twin ({name})")
        before = kernels.launch_counts()["pool_insert"]
        got, again, want, twin = (pool.clone() for _ in range(4))
        kernels.pool_insert(got, *args[1:], **live)
        kernels.pool_insert(again, *args[1:], **live)
        kernels.pool_insert_ordered(want, *args[1:], **live)
        kernels.pool_insert_ref(twin, *args[1:], **live)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["pool_insert"] == before + 2,
              f"pool_insert did not count its launches ({name})")
        alive = live_slots(pool, live)
        check(bool(torch.isfinite(got).all()), f"pool_insert: non-finite cells ({name})")
        check(torch.equal(bits(got[alive]), bits(want[alive])),
              f"pool_insert differs from the ordered sums ({name}): "
              f"{int((got != want)[alive].any(-1).sum())} cells")
        check(torch.equal(bits(got), bits(again)), f"pool_insert: two launches differ ({name})")
        check(torch.equal(bits(got[~alive]), bits(pool[~alive])),
              f"pool_insert changed a dead slot ({name})")
        runs = kernels.pool_insert_runs(*args[:4], *args[5:], live.get("refcnt"))
        differ = (got != twin).any(-1) & alive[:, None, None]
        short = int((differ & (runs < 32)).sum())
        rel = float(((got - twin).abs() / twin.abs().clamp(min=1e-30))[alive].max())
        err = float((got - twin)[alive].abs().max())
        print(f"pool_insert [{name}]: {tuple(pool.shape)}, {tables.shape[0]} tables, "
              f"{int(alive.sum())} live slots, {int(touched.sum())} touched tiles: equal to the "
              f"ordered sums bit for bit on every live slot, two launches equal, dead slots kept; "
              f"against the twin {int(differ.sum())} cells differ ({short} outside runs of 32 or "
              f"more samples), max relative difference {rel:.3e}; marks equal to the twin",
              flush=True)
        check(short == 0, f"pool_insert parts from its twin outside long runs ({name})")
        differing += int(differ.sum())
        max_err = max(max_err, err)

    by_path, touch_by_path = {}, {}
    for path, calls in kept.items():
        args, live = calls[min(4, len(calls) - 1)]
        pool, tables, origin, scale, model, poses, scans, cfg, touched, q = args
        work = pool.clone()
        items = kernels.pool_work(pool, tables, origin, scale, poses, scans, cfg, touched, **live)

        def insert():
            kernels.pool_insert(work, *args[1:], **live, work=items)

        def plain():
            kernels.pool_insert_ref(work, *args[1:], **live)

        def touch():
            kernels.pool_touched(tuple(tables.shape[1:]), pool.shape[1], origin, scale, poses,
                                 scans, cfg, q)

        def touch_plain():
            kernels.pool_touched_ref(tuple(tables.shape[1:]), pool.shape[1], origin, scale,
                                     poses, scans, cfg, q)

        device_ms = graph_ms(insert)
        ms, plain_ms, chained = time_pair(insert, plain, plain_calls=10)
        t_device_ms = graph_ms(touch)
        t_ms, t_plain_ms, t_chained = time_pair(touch, touch_plain, plain_calls=10)
        n_bytes, n_ops, alive, t_bytes, t_ops = pool_work(args, live)
        b_ms, by = bound_ms(n_bytes, n_ops)
        tb_ms, tby = bound_ms(t_bytes, t_ops)
        n_items = int(items.buf[2])
        print(f"pool_insert {path} {tuple(pool.shape)} {tables.shape[0]} tables "
              f"{type(model).__name__}, {alive} live slots, {n_items} items of its work list: "
              f"{1e3 * device_ms:.2f} us device (a "
              f"CUDA graph of 50 calls), a call {ms:.4f} ms, chained {chained:.4f} ms; plain twin "
              f"{plain_ms:.4f} ms a call; bound {b_ms:.6f} ms by {by} ({n_bytes} B; {n_ops} "
              f"operations) on {smi}; no single PyTorch call computes it", flush=True)
        print(f"pool_touched {path} {tuple(touched.shape)}: {1e3 * t_device_ms:.2f} us device, a "
              f"call {t_ms:.4f} ms, chained {t_chained:.4f} ms; plain twin {t_plain_ms:.4f} ms a "
              f"call; bound {tb_ms:.6f} ms by {tby} ({t_bytes} B; {t_ops} operations) on {smi}; "
              f"no single PyTorch call computes it", flush=True)
        by_path[path] = {"device_ms": device_ms, "ms": ms, "plain_ms": plain_ms,
                         "chained_ms": chained, "bound_ms": b_ms, "bound_by": by,
                         "live_slots": alive, "items": n_items}
        touch_by_path[path] = {"device_ms": t_device_ms, "ms": t_ms, "plain_ms": t_plain_ms,
                               "chained_ms": t_chained, "bound_ms": tb_ms, "bound_by": tby}
    print(f"pool_insert: {len(cases)} cases equal to the ordered sums bit for bit on every live "
          f"slot; {differing} cells differ from the twin, each in a run the card's index_put_ "
          f"sums by a warp", flush=True)
    src = "slam_constructor_tpu_torch/csrc/scan_insert.cu"
    k_prep = phase_pool_prepare(prep_kept, smi)
    return ({"name": "pool_insert", "route": "cuda", "source": src,
             "replaces": "slam_constructor_tpu/ops/blockmap.py:117", "max_abs_err": max_err,
             "cases_bitwise_equal_to_ordered_sums": len(cases),
             "cells_differing_from_twin": differing, **by_path["gmapping cow"],
             "by_path": by_path, "library_ms": None},
            {"name": "pool_touched", "route": "cuda", "source": src,
             "replaces": "slam_constructor_tpu/ops/blockmap.py:128", "max_abs_err": max_touch_err,
             **touch_by_path["gmapping cow"], "by_path": touch_by_path, "library_ms": None},
            k_prep)


# --- slice 6d: every matcher in every slot, the gradient at every reducer, checkpoints ---

#: winner ATE of the JAX reference's RBPF with the hill-climbing refine after
#: the Monte-Carlo match (``gmapping_slot_config('monte_carlo',
#: 'hill_climbing')``) on a CPU over the bench sequence, once for each key
#: PRNGKey(0..4) (`JAX_PLATFORMS=cpu python scripts/torch_port/
#: reference_ate.py --preset gmapping --slot monte_carlo+hill_climbing --keys 5 --port`)
GMAPPING_HILL_REFERENCE_ATE_BY_KEY = (0.62062, 0.66941, 0.62501, 0.72555, 0.6784)
#: corrected-trajectory ATE of the reference's ``FullSlamEngine`` with the
#: hill-climbing and with the gradient loop matcher (``full_loop_config``)
#: on a CPU over the full path's sequence, once for each tracker key
#: (`reference_ate.py --preset full_hill|full_gradient --keys 5 --port`)
FULL_HILL_REFERENCE_ATE_BY_KEY = (0.1127, 0.11358, 0.1256, 0.11189, 0.11696)
FULL_GRADIENT_REFERENCE_ATE_BY_KEY = (0.08057, 0.0768, 0.09442, 0.07778, 0.08254)
#: every how many launches of a slot's kernel a path run keeps its arguments
SLOT_KEEP_EVERY = 64
#: a gradient refine against its twin on the beams clear of kinks, every
#: decision the same: the poses within this (m), a thousandth of a 0.1 m
#: cell (the step's direction g / |g| magnifies the sums' rounding where the
#: beams' derivatives nearly cancel)
GRADIENT_POSE_TOL = 1e-4
#: scans of the slots' card-vs-CPU runs and of the checkpoint runs
SLOT_VS_CPU_SCANS, CHECKPOINT_SCANS = 8, 64


def slot_name(matcher, refine):
    return matcher if refine is None else f"{matcher}+{refine}"


def matcher_launches(kind, mcfg, lead=True) -> dict:
    """The launches of one match (or refine) of matcher ``kind`` over one
    map or M (``lead``): a Monte-Carlo match, the hill climb and the
    gradient ascent one launch each (a piecewise-constant gradient one
    score instead), M3RSM its pyramid and its search, brute force a
    batched score."""
    from slam_constructor_tpu_torch.ops import scoring

    score = "overlap_score_batched" if lead else "overlap_score"
    if kind == "gradient":
        flat = scoring.reducer_of(mcfg.scoring).flat
        return {score: 1} if flat else {"gradient_refine": 1}
    return {"monte_carlo": {"mc_match_batched" if lead else "mc_match": 1},
            "hill_climbing": {"hill_climb": 1}, "brute_force": {score: 1},
            "m3rsm": {"m3rsm_pyramid": 1, "m3rsm_search": 1}}[kind]


def slot_launches(cfg, n) -> dict:
    """The launches the design gives ``n`` RBPF steps of ``cfg``: its match
    and its refine over the P windows, the insert (K3 on the dense maps,
    the pool's prepare and insert on the copy-on-write storage)."""
    counts = {}
    for kind, mcfg in ((cfg.matcher, cfg.matcher_cfg), (cfg.refine_matcher, cfg.refine_cfg)):
        if kind is not None:
            for k, v in matcher_launches(kind, mcfg).items():
                counts[k] = counts.get(k, 0) + v * n
    insert = (dict(pool_prepare=n, pool_insert=n) if cfg.map_storage == "cow"
              else dict(scan_insert=n))
    return expect(**counts, **insert, prng_draws=n)


def slot_runs():
    """(name, config) of the RBPF's slot runs: every slot on the dense maps,
    two on the copy-on-write pool."""
    runs = [(f"gmapping {slot_name(m, r)}", gmapping_slot_config(m, r)) for m, r in GM_SLOTS]
    for m, r in (("monte_carlo", "hill_climbing"), ("gradient", None)):
        runs.append((f"gmapping cow {slot_name(m, r)}", gmapping_slot_config(m, r, cow_config())))
    return runs


def phase_gmapping_slots(scans, odom, gt, odo_ate, smi):
    """Every matcher in every RBPF slot at bench.py's gmapping width (512
    scans, sync check on), on the dense maps and (two slots) on the
    copy-on-write pool: launches, the winner's ATE (the Monte-Carlo match
    with the hill-climbing refine held to the reference's keys), two runs
    of the hill-climbing refine equal. Keeps every 64th launch of the
    slots' kernels. Returns the launches by run, the kept calls and a
    summary."""
    from slam_constructor_tpu_torch.ops import kernels
    from slam_constructor_tpu_torch.utils import evaluate

    names = ("gradient_refine", "hill_climb", "m3rsm_pyramid")
    launches, summary = {}, {}
    kept = {k: {} for k in (*names, "m3rsm_search")}
    for name, cfg in slot_runs():
        run_gmapping_path(cfg, scans[:8], odom[:8], gt, 0)  # warm-up: constants, build
        recs = {k: recorder(getattr(kernels, k), SLOT_KEEP_EVERY) for k in names}
        searching, searches = search_recorder(lambda n: n % SLOT_KEEP_EVERY == 0)
        with contextlib.ExitStack() as stack:
            for k, (rec, _) in recs.items():
                stack.enter_context(handed_in(rec, k))
            stack.enter_context(handed_in(searching, "m3rsm_search"))
            with pool_twin_counted() as twin_calls:
                reset_launches()
                e, traj, neffs, secs = run_gmapping_path(cfg, scans, odom, gt, "error")
                got = read_launches()
        for k, (_, calls) in recs.items():
            if calls:
                kept[k][name] = calls
        if searches:
            kept["m3rsm_search"][name] = searches
        launches[name] = got
        want = slot_launches(cfg, N_SCANS)
        winner = e.winner_trajectory()
        ate = float(evaluate.ate(winner, gt, align=False))
        print(f"{name} ({cfg.n_particles} particles): {N_SCANS} scans in {secs:.3f} s = "
              f"{N_SCANS / secs:.1f} scans/s on {smi}, sync check on, no host sync; winner ATE "
              f"{ate:.4f} m, online {float(evaluate.ate(traj, gt, align=False)):.4f} m, odometry "
              f"{odo_ate:.4f} m; min Neff {float(neffs.min()):.2f}; launches {got} (expected "
              f"{want})", flush=True)
        check(got == want, f"{name}: launches {got}, expected {want}")
        check(not twin_calls, f"{name}: a plain version ran on the card's path")
        check(bool(torch.isfinite(winner).all()) and bool(torch.isfinite(traj).all())
              and bool(torch.isfinite(e.occupancy).all()), f"{name}: non-finite poses or map")
        summary[name] = {"scans_per_sec": N_SCANS / secs, "winner_ate_m": ate}
        if name == "gmapping monte_carlo+hill_climbing":
            ref = GMAPPING_HILL_REFERENCE_ATE_BY_KEY
            limit = max(ref) + GMAPPING_ATE_MARGIN
            print(f"{name}: winner ATE {ate:.4f} m against the reference's worst key + margin "
                  f"{limit:.4f} (its five keys {min(ref):.4f}-{max(ref):.4f})", flush=True)
            check(ate <= limit, f"{name}: winner ATE {ate} above the reference's worst key + "
                                f"margin {limit}")
            e2, traj2, _, _ = run_gmapping_path(cfg, scans, odom, gt, 0)
            same = torch.equal(traj2, traj) and all(
                torch.equal(a, b) for a, b in zip(gmapping_bits(e), gmapping_bits(e2)))
            print(f"{name} repeatability: trajectory, genealogy, weights and maps of two runs "
                  f"equal: {same}", flush=True)
            check(same, f"{name}: two runs differ")
    return launches, kept, summary


def gradient_part_explained(name, card, cpu) -> bool:
    """Why a run with a gradient refine parts on the card and the CPU:
    ``card`` and ``cpu`` are the arguments of the refine (one map or M)
    each device ran at the scan where the runs part. The gradient ascent
    steps along g / |g|, and a beam's endpoint within an ulp of a kink of
    the score (where the derivative jumps) takes the derivative of either
    side on the two devices (their cosf and sinf differ by an ulp): the
    step turns. Explained when every map whose refine parts had a weighted
    endpoint within KINK_MARGIN cell of a kink on its way on the CPU, or
    the refine held a keep-if-better decision closer than KNIFE_EDGE."""
    from slam_constructor_tpu_torch.ops import kernels

    def as_maps(a):
        return a if a[0].dim() == 3 else (*(t[None] for t in a[:5]), *a[5:])

    card, cpu = as_maps(card), as_maps(cpu)
    start = float((card[4].cpu() - cpu[4]).abs().max())
    got_card, got_cpu = kernels.gradient_refine(*card), kernels.gradient_refine(*cpu)
    torch.cuda.synchronize()
    dp = (got_card[0].cpu() - got_cpu[0]).abs().amax(-1)
    parted = dp > 1e-5
    poses = visited_poses(kernels.gradient_refine_loop, kernels.overlap_score_grad_ref, cpu)
    near = ~kernels.clear_of_kinks(poses, cpu[1], cpu[3], cpu[5], KINK_MARGIN, cpu[11])
    near = (near & (cpu[2] != 0)).any(-1)
    margins = twin_record(cpu, kernels.gradient_refine_loop, kernels.overlap_score_grad_ref)[1]
    edge = float(margins.min()) if margins.numel() else math.inf
    kinked = bool(near[parted].all())
    print(f"  [{name}] the refine where the runs part ({cpu[0].shape[0]} maps, start poses "
          f"{start:.3e} apart): {int(parted.sum())} maps part (up to {float(dp.max()):.3e} m); "
          f"each had a weighted endpoint within {KINK_MARGIN:g} cell of a kink on its way: "
          f"{kinked} ({int(near.sum())} of {near.numel()} had one); closest keep-if-better "
          f"decision {edge:.3e} (limit {KNIFE_EDGE:g})", flush=True)
    return kinked or edge < KNIFE_EDGE


def climb_part_explained(name, card_calls, cpu_calls) -> bool:
    """Why a run with a Monte-Carlo match or a hill climb (no gradient)
    parts on the card and the CPU at a scan: ``card_calls`` and
    ``cpu_calls`` hold each device's calls of that scan, by wrapper
    (``mc_match_batched``, ``hill_climb``). The calls are taken in the
    step's order (the match, then the refine). A call whose inputs differ
    on the two devices is not explained: the parting began upstream, so
    the check fails there. A call whose inputs agree is run on the card
    with the CPU's arguments and held against the plain twin on them
    (``twin_record``: the candidates' margins); where the results part,
    the parting is explained only when every match that parts had a
    decision closer than KNIFE_EDGE (the sums' order, trap k). Calls whose
    inputs agree and whose results agree are passed over; no explanation
    by the last call is none."""
    from slam_constructor_tpu_torch.ops import kernels

    loops = (("mc_match_batched", kernels.mc_match_batched, kernels.mc_match_loop),
             ("hill_climb", kernels.hill_climb, kernels.hill_climb_loop))

    def gap(a, b):  # how far an argument of the card's call is from the CPU's
        a, b = draws_of(a), draws_of(b)
        if not isinstance(b, torch.Tensor):
            return 0.0 if a == b else math.inf
        a = a.cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            return math.inf
        if not b.is_floating_point():
            return 0.0 if torch.equal(a, b) else math.inf
        if not torch.equal(a.isnan(), b.isnan()):
            return math.inf
        return float((a - b).nan_to_num().abs().max()) if b.numel() else 0.0

    for kind, kernel, loop in loops:
        for card, cpu in zip(card_calls.get(kind, []), cpu_calls.get(kind, [])):
            gaps = [gap(a, b) for a, b in zip(card, cpu)]
            if any(g != 0 for g in gaps):
                print(f"  [{name}] {kind}: the inputs differ on the two devices (max|diff| by "
                      f"argument {['%.1e' % g for g in gaps]}): the runs parted before this "
                      f"call", flush=True)
                return False
            dev = card[0].device
            moved = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in cpu)
            got = [t.cpu() for t in kernel(*moved)]
            twin, margins = twin_record(cpu, loop, kernels.overlap_score_ref)
            if twin[0].dim() == 1:
                twin, margins = [t[None] for t in twin], margins[None]
                got = [t[None] for t in got]
            apart = (got[0] - twin[0]).abs().amax(-1) > 1e-5
            edge = (margins.amin(-1) if margins.shape[-1]
                    else torch.full(apart.shape, math.inf))
            print(f"  [{name}] {kind}: the inputs agree on the two devices; the card's kernel "
                  f"on them parts from the twin on {int(apart.sum())} matches (their closest "
                  f"decisions {[float('%.2e' % float(x)) for x in edge[apart]]}, limit "
                  f"{KNIFE_EDGE:g})", flush=True)
            if bool(apart.any()):
                return bool((edge[apart] < KNIFE_EDGE).all())
    return False


def phase_gmapping_slots_card_vs_cpu(dev, scans, odom, gt, n=SLOT_VS_CPU_SCANS):
    """Card vs CPU: the first ``n`` scans of every slot run with the same
    draws (made with numpy): poses and log-weights within 1e-4, ancestors
    equal; where a run with a gradient slot parts, that scan's refine must
    explain it (``gradient_part_explained``); where another run parts, a
    match or climb decided closer than KNIFE_EDGE must
    (``climb_part_explained``)."""
    from slam_constructor_tpu_torch.ops import kernels

    for name, cfg in slot_runs():
        draws = rbpf_draws(cfg, n)
        runs, calls, others = [], [], []
        for d in (None, "cpu"):
            on = torch.device(d) if d else dev
            ascending, ascents = recorder(kernels.gradient_refine)
            matching, matches = recorder(kernels.mc_match_batched)
            climbing, climbs = recorder(kernels.hill_climb)
            with handed_in(ascending, "gradient_refine"), \
                    handed_in(matching, "mc_match_batched"), handed_in(climbing, "hill_climb"):
                e, _, _, _ = run_gmapping_path(cfg, scans[:n].to(on), odom[:n].to(on),
                                               gt.to(on), 0, draws=draws, device=d)
            runs.append([t.cpu() for t in (*e.genealogy, e.state.log_weights)])
            calls.append(ascents)
            others.append({"mc_match_batched": matches, "hill_climb": climbs})
        (pa, aa, la), (pb, ab, lb) = runs
        d = pa - pb
        d[..., 2] = torch.atan2(torch.sin(d[..., 2]), torch.cos(d[..., 2]))
        by_scan = d.abs().amax((1, 2))
        apart = (by_scan > 1e-4) | (aa != ab).any(1)
        part = int(apart.nonzero()[0]) if bool(apart.any()) else None
        diff, ldiff = float(by_scan.max()), float((la - lb).abs().max())
        print(f"{name} card vs CPU, {n} scans, the same draws: max|pose diff| {diff:.3e} (tol "
              f"1e-4), ancestors equal: {torch.equal(aa, ab)}, max|log-weight diff| {ldiff:.3e} "
              f"(tol 1e-4){'' if part is None else f'; the runs part at scan {part}'}",
              flush=True)
        if part is None:
            check(ldiff <= 1e-4, f"{name} card vs CPU: the weights disagree")
            continue
        if calls[1]:
            explained = len(calls[1]) == n and gradient_part_explained(name, calls[0][part],
                                                                       calls[1][part])
        else:
            def of_scan(c):
                return {k: v[part:part + 1] if len(v) == n else v for k, v in c.items()}

            explained = climb_part_explained(name, of_scan(others[0]), of_scan(others[1]))
        check(explained,
              f"{name} card vs CPU: the runs part at scan {part} with no kink or close decision")


def capture_loop_refines(cfg, scans, odom, gt):
    """A run of a full path (it also warms the path up) that keeps every
    launch of the loop closer's refine kernels (``hill_climb``,
    ``gradient_refine``)."""
    from slam_constructor_tpu_torch.ops import kernels

    climbing, climbs = recorder(kernels.hill_climb)
    ascending, ascents = recorder(kernels.gradient_refine)
    with handed_in(climbing, "hill_climb"), handed_in(ascending, "gradient_refine"):
        run_full_path(cfg, scans, odom, gt, 0)
    return {"hill_climb": climbs, "gradient_refine": ascents}


def joint_refine_state(dev, fscans, fgt, n_kf=8):
    """phase 35's joint refine: ``n_kf`` keyframes of the full sequence (40
    scans apart) at their true poses, the tracker's empty map and beam."""
    from slam_constructor_tpu_torch.models import posegraph
    from slam_constructor_tpu_torch.ops import grid as gridlib

    tracking = full_config().tracking
    cfg = posegraph.PoseGraphConfig(max_keyframes=n_kf, max_edges=2 * n_kf)
    st = posegraph.init_state(cfg, N_BEAMS, dev)
    for i in range(n_kf):
        st = posegraph.add_keyframe(cfg, st, fgt[40 * i], fscans[40 * i])
    gm = gridlib.make_grid_map(tracking.cell_model, MAP, MAP, tracking.map_scale, device=dev)
    return cfg, tracking, st, gm


def pose_gap(a, b) -> float:
    """The largest difference of two sets of poses, headings wrapped."""
    d = a - b
    d[..., 2] = torch.atan2(torch.sin(d[..., 2]), torch.cos(d[..., 2]))
    return float(d.abs().max())


def phase_joint_refine_slots(dev, fscans, fgt, rounds=2):
    """``posegraph.joint_refine`` with the hill climb, the gradient ascent
    and M3RSM (the reference's default configs) over 8 keyframes of the
    full sequence, on the card (launches: a ``scan_planes`` and the
    matcher's over the 8 leave-one-out maps a round) and on the CPU (poses
    within 1e-4). Returns the launches by matcher and the kept calls."""
    from slam_constructor_tpu_torch.models import posegraph
    from slam_constructor_tpu_torch.ops import kernels, matchers

    launches, kept = {}, {}
    for matcher in ("hill_climbing", "gradient", "m3rsm"):
        outs = []
        for first, on in ((True, dev), (False, torch.device("cpu"))):
            cfg, tracking, st, gm = joint_refine_state(on, fscans.to(on), fgt.to(on))
            recs = {k: recorder(getattr(kernels, k)) for k in ("hill_climb", "gradient_refine",
                                                                "m3rsm_pyramid")}
            searching, searches = search_recorder()
            with contextlib.ExitStack() as stack:
                for k, (rec, _) in recs.items():
                    stack.enter_context(handed_in(rec, k))
                stack.enter_context(handed_in(searching, "m3rsm_search"))
                reset_launches()
                out = posegraph.joint_refine(cfg, tracking.cell_model, st, gm, tracking.beam,
                                             rounds=rounds, matcher=matcher)
                if on.type == "cuda":
                    torch.cuda.synchronize()
                got = read_launches()
            outs.append(out.kf_poses.cpu())
            if first:
                launches[matcher] = got
                for k, (_, calls) in recs.items():
                    if calls:
                        kept[k] = calls
                if searches:
                    kept["m3rsm_search"] = searches
                mcfg = matchers.MATCHERS[matcher][0]()
                want = expect(scan_planes=rounds, **{
                    k: v * rounds for k, v in matcher_launches(matcher, mcfg).items()})
                check(got == want, f"joint_refine {matcher}: launches {got}, expected {want}")
        diff = pose_gap(outs[0], outs[1])
        moved = pose_gap(outs[0], st.kf_poses.cpu())
        edge = math.inf
        if diff > 1e-4 and matcher == "gradient":
            # a gradient ascent's late steps gain ~1e-7: a keep-if-better may
            # fall the other way; the card's refines must hold such a decision
            edge = min(float(twin_record(a, kernels.gradient_refine_loop,
                                         kernels.overlap_score_grad_ref)[1].min())
                       for a in kept["gradient_refine"])
        near = ("" if edge == math.inf else f"; the closest decision of its refines in their "
                f"twin {edge:.3e}, limit {KNIFE_EDGE:g}")
        print(f"joint_refine with {matcher} ({rounds} rounds, 8 keyframes of the full sequence, "
              f"the reference's default config): launches {launches[matcher]}; card vs CPU "
              f"max|pose diff| {diff:.3e} (tol 1e-4{near}); the keyframes moved up to "
              f"{moved:.4f}", flush=True)
        check(bool(torch.isfinite(outs[0]).all()) and (diff <= 1e-4 or edge < KNIFE_EDGE),
              f"joint_refine {matcher}: the card and the CPU disagree")
    return launches, kept


def refined_properties(label, edits):
    """configs/tiny_refined.properties with ``edits`` (key: value) applied,
    written under build/cli_out/; returns its path."""
    lines, seen = [], set()
    with open("configs/tiny_refined.properties") as f:
        for line in f.read().splitlines():
            key = line.split("=", 1)[0].strip()
            if key in edits:
                line, seen = f"{key} = {edits[key]}", seen | {key}
            lines.append(line)
    lines += [f"{k} = {v}" for k, v in edits.items() if k not in seen]
    os.makedirs("build/cli_out", exist_ok=True)
    path = f"build/cli_out/tiny_refined_{label}.properties"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase_cli_refine_reducers(dev):
    """The CLI's tiny_refined with its gradient refine at the obstacle
    reducer (piecewise constant: one ``overlap_score`` a scan, the match's
    pose kept: the same trajectory as without the refine, bit for bit) and
    at the general overlap of extent 1.5 (one ``gradient_refine`` a scan);
    card vs CPU on 8 scans each. Returns the launches and every 16th refine
    at extent 1.5."""
    from slam_constructor_tpu_torch import run
    from slam_constructor_tpu_torch.ops import kernels
    from slam_constructor_tpu_torch.utils import config as cfglib
    from slam_constructor_tpu_torch.utils import evaluate

    launches, kept = {}, []
    for label, edits in (("obstacle", {"scoring.reducer": "obstacle"}),
                         ("overlap_e1.5", {"scoring.overlap_extent": "1.5"})):
        path = refined_properties(label, edits)
        args = run.parse_args(["--config", path, "--synthetic", "cecum", "--trajectory",
                               "rectangle", "--steps", str(CLI_SCANS), "--out",
                               f"build/cli_out/tiny_refined_{label}"])
        ascending, calls = recorder(kernels.gradient_refine, every=16)
        with handed_in(ascending, "gradient_refine"):
            run.execute(args)  # warm-up
            calls.clear()
            reset_launches()
            res = run.execute(args)
            got = read_launches()
        n = res.trajectory.shape[0]
        name = f"cli tiny_refined {label.replace('_', ' ')}"
        launches[name] = got
        props = cfglib.load_properties(path)
        cfg = cfglib.engine_config_from(props)
        refine = matcher_launches("gradient", cfg.refine_cfg, lead=False)
        want = expect(mc_match=n, scan_insert=n, prng_draws=1,
                      **{k: v * n for k, v in refine.items()})
        scans, odom, gt = run.load_data(args, dev)
        print(f"{name}: {n} scans, {res.summary['scans_per_sec']} scans/s; ATE "
              f"{float(evaluate.ate(res.trajectory, gt, align=False)):.5f} m; launches {got} "
              f"(expected {want})", flush=True)
        check(got == want, f"{name}: launches {got}, expected {want}")
        check(bool(torch.isfinite(res.trajectory).all()), f"{name}: non-finite poses")
        if label == "obstacle":
            plain = dataclasses.replace(cfg, refine_matcher=None, refine_cfg=None)
            traj = run_main_path(plain, scans, odom, gt, 0)[0]
            same = torch.equal(traj, res.trajectory)
            print(f"{name}: the same engine without the refine gives the same trajectory bit "
                  f"for bit: {same}", flush=True)
            check(same, f"{name}: the flat refine moved a pose")
        else:
            kept = list(calls)
        refine_card_vs_cpu(name, cfg, dev, scans, odom, gt)
    return launches, kept


def refine_card_vs_cpu(name, cfg, dev, scans, odom, gt, n=8):
    """``phase_card_vs_cpu`` for an engine with a gradient refine: where the
    runs part, the scan's refine must explain it
    (``gradient_part_explained``)."""
    from slam_constructor_tpu_torch.models import engine
    from slam_constructor_tpu_torch.ops import kernels

    rounds, batch = cfg.matcher_cfg.rounds, cfg.matcher_cfg.batch
    noise = torch.from_numpy(
        np.random.default_rng(5).standard_normal((n, rounds, batch, 3)).astype(np.float32))
    trajs, calls = [], []
    for d in (dev, torch.device("cpu")):
        ascending, ascents = recorder(kernels.gradient_refine)
        with handed_in(ascending, "gradient_refine"):
            e = engine.Engine(cfg, device=d)
            e.state.pose = gt[0].to(d).clone()
            traj, _ = e.run(scans[:n], odom[:n], noise=noise.to(d))
        trajs.append(traj.cpu())
        calls.append(ascents)
    d = trajs[0] - trajs[1]
    d[..., 2] = torch.atan2(torch.sin(d[..., 2]), torch.cos(d[..., 2]))
    by_scan = d.abs().amax(-1)
    part = int((by_scan > 1e-4).nonzero()[0]) if bool((by_scan > 1e-4).any()) else None
    print(f"{name} card vs CPU, {n} scans: max|pose diff|={float(by_scan.max()):.3e} (tol 1e-4)"
          f"{'' if part is None else f'; the runs part at scan {part}'}", flush=True)
    check(part is None or (len(calls[1]) == n and gradient_part_explained(
        name, calls[0][part], calls[1][part])), f"{name}: card and CPU runs disagree")


def phase_checkpoint(dev, scans, odom, gt, fscans, fodom, fgt, n=CHECKPOINT_SCANS):
    """A run stopped, saved (``utils.checkpoint``; the full pipeline's
    ``save_checkpoint``), restored into a fresh engine on the card and
    finished equals the unbroken run bit for bit: the RBPF with the
    hill-climbing refine (dense and copy-on-write), viny_m3rsm (its
    pyramid), and the full pipeline with the hill-climbing loop matcher
    (the full sequence, saved after its first lap, in segments of ``n``)."""
    from slam_constructor_tpu_torch.models import engine, full, gmapping, viny
    from slam_constructor_tpu_torch.utils import checkpoint

    half = n // 2
    os.makedirs("build/checkpoint", exist_ok=True)
    makers = {
        "gmapping monte_carlo+hill_climbing": lambda: gmapping.GMappingEngine(
            gmapping_slot_config("monte_carlo", "hill_climbing"), seed=0),
        "gmapping cow monte_carlo+hill_climbing": lambda: gmapping.GMappingEngine(
            gmapping_slot_config("monte_carlo", "hill_climbing", cow_config()), seed=0),
        "viny_m3rsm": lambda: engine.Engine(viny.viny_m3rsm_config(map_size=MAP), seed=0),
    }
    for name, make in makers.items():
        def fresh():
            e = make()
            if isinstance(e, gmapping.GMappingEngine):
                e.state.poses = gt[0].expand(e.cfg.n_particles, 3).clone()
            else:
                e.state = dataclasses.replace(e.state, pose=gt[0].clone())
            return e

        ref = fresh()
        want = torch.cat([ref.run(scans[:half], odom[:half])[0],
                          ref.run(scans[half:n], odom[half:n])[0]])
        a = fresh()
        first = a.run(scans[:half], odom[:half])[0]
        path = f"build/checkpoint/{name.replace(' ', '_')}"
        checkpoint.save(path, {"state": a.state})  # the state holds its key
        b = fresh()
        b.state = checkpoint.restore(path, {"state": b.state})["state"]
        got = torch.cat([first, b.run(scans[half:n], odom[half:n])[0]])
        same = torch.equal(got, want)
        print(f"checkpoint {name}: {half} scans, saved, restored into a fresh engine on the "
              f"card, {n - half} more: the trajectory equals the unbroken run's bit for bit: "
              f"{same}", flush=True)
        check(same, f"checkpoint {name}: the resumed run differs")
    cfg = full_loop_config("hill_climbing")
    seg = n

    def fresh_full():
        e = full.FullSlamEngine(cfg, n_beams=N_BEAMS, seed=0)
        e.state.pose = fgt[0].clone()
        return e

    fn = N_SCANS  # the whole sequence: the first lap before the save, the second after
    ref = fresh_full()
    ref.run(fscans[:fn // 2], fodom[:fn // 2], segment=seg)
    ref.run(fscans[fn // 2:fn], fodom[fn // 2:fn], segment=seg)
    a = fresh_full()
    a.run(fscans[:fn // 2], fodom[:fn // 2], segment=seg)
    a.save_checkpoint("build/checkpoint/full_hill")
    b = fresh_full()
    b.restore_checkpoint("build/checkpoint/full_hill")
    b.run(fscans[fn // 2:fn], fodom[fn // 2:fn], segment=seg)
    same = (torch.equal(b.corrected_trajectory(), ref.corrected_trajectory())
            and all(torch.equal(x, y) for x, y in zip(graph_bits(b), graph_bits(ref)))
            and (b.total_loops, b.n_bursts) == (ref.total_loops, ref.n_bursts))
    print(f"checkpoint full hill_climbing: {fn // 2} scans ({a.total_loops} loops, {a.n_bursts} "
          f"bursts), saved, restored, {fn - fn // 2} more: corrected trajectory, graph, map and "
          f"counters equal the unbroken run's bit for bit: {same}", flush=True)
    check(same, "checkpoint full: the resumed run differs")


def refine_twin(name):
    from slam_constructor_tpu_torch.ops import kernels

    if name == "gradient_refine":
        return (kernels.gradient_refine_rounds, kernels.gradient_refine_ref,
                kernels.gradient_refine_loop, kernels.overlap_score_grad_ref,
                kernels.overlap_score_grad)
    def score(v, *a):
        return (kernels.overlap_score_batched if v.dim() == 3 else kernels.overlap_score)(v, *a)

    return (kernels.hill_climb_rounds, kernels.hill_climb_ref, kernels.hill_climb_loop,
            kernels.overlap_score_ref, score)


def refine_cells(args, poses, red):
    """The distinct cells the taps of ``poses`` f32[M, N, 3] read (one map:
    a leading dimension added)."""
    v, pts, beam_w, origin, scale = args[0], args[1], args[2], args[3], args[5]
    if v.dim() == 2:
        v, pts, beam_w, origin = v[None], pts[None], beam_w[None], origin[None]
        poses = poses[None]
    if red.kind == "bilinear":
        return tap_cells_maps(v, poses, pts, beam_w, origin, scale)[0]
    return reducer_tap_cells(v, poses, pts, beam_w, origin, scale, red)


def grad_ops(red) -> int:
    """f32 operations a (pose, beam) pair of the pose gradient: the score's
    and, for the general overlap, a cell's two length derivatives (2 x 4),
    the weights' two derivatives and their four sums (6), the quotient rule
    (6) and the chain to the pose (19); the bilinear's GRAD_OPS_PER_POINT;
    the piecewise-constant reducers the score's alone."""
    if red.kind == "bilinear":
        return GRAD_OPS_PER_POINT
    if red.flat:
        return reducer_ops(red)
    return reducer_ops(red) + (2 * red.radius + 1) ** 2 * 14 + 6 + 19


def clear_of_refine_kinks(args, loop, score, passes=32):
    """A gradient refine's arguments with the beams whose endpoint comes
    within KINK_MARGIN cell of a kink of the reducer's score, at a pose the
    refine visits, at weight 0: repeated on the masked arguments (whose
    refine visits other poses) until no beam is added, at most ``passes``
    times. Over 30 windows a mask can take more than 8 passes to settle (a
    window of the gmapping gradient slot's path took 7 on the CPU alone;
    `scripts/torch_port/refine_parts.py`), and a mask cut short leaves a
    kinked beam on the path."""
    from slam_constructor_tpu_torch.ops import kernels

    masked = args
    for _ in range(passes):
        poses = visited_poses(loop, score, masked)
        clear = kernels.clear_of_kinks(poses, args[1], args[3], args[5], KINK_MARGIN, args[11])
        weights = (masked[2] * clear).contiguous()
        if torch.equal(weights, masked[2]):
            break
        masked = (*masked[:2], weights, *masked[3:])
    return masked


def refine_entry(name, label, calls, launches, smi):
    """A one-launch refine (``gradient_refine`` or ``hill_climb``) on calls
    kept from a path, one map or M: bit for bit its yardstick and (M) single
    launches, against its plain twin (within 2e-6, or a close decision
    before they part), then timed on the last call beside the yardstick and
    the twin, with its bound by the distinct cells the taps of every pose
    it scores read. Returns the `kernels` entry."""
    from slam_constructor_tpu_torch.ops import kernels

    kernel = getattr(kernels, name)
    yardstick, twin, loop, twin_score, score = refine_twin(name)
    check(len(calls) > 0, f"{name} [{label}]: no call kept")
    max_err, parted, max_pose = 0.0, 0, 0.0
    for i, args in enumerate(calls):
        got, want = kernel(*args), yardstick(*args)
        lead = args[0].shape[:-2]
        firsts = range(0, lead[0], 7) if lead else []
        singles = [kernel(*(a[m] for a in args[:5]), *args[5:]) for m in firsts]
        twin_out, margins = twin_record(args, loop, twin_score)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
              f"{name} [{label} call {i}] differs from {yardstick.__name__}")
        check(all(torch.equal(bits(a[::7]), bits(torch.stack(b))) for a, b in
                  zip(got, zip(*singles))) if lead else True,
              f"{name} [{label} call {i}] differs from single-map launches")
        pose_tol = 1e-5
        if name == "gradient_refine" and not args[11].flat:
            # the gradient jumps at the score's kinks, and the kernel and the
            # twin may place an endpoint an ulp apart: they are compared with
            # the beams that come within KINK_MARGIN of a kink at weight 0.
            # Near an optimum the beams' derivatives nearly cancel, and g / |g|
            # magnifies their sums' rounding: with every decision the same,
            # the poses are held to GRADIENT_POSE_TOL
            masked = clear_of_refine_kinks(args, loop, score)
            got = kernel(*masked)
            twin_out, margins = twin_record(masked, loop, twin_score)
            pose_tol = GRADIENT_POSE_TOL
        maps = range(lead[0]) if lead else [None]
        for m in maps:
            pick = (lambda t: t) if m is None else (lambda t, m=m: t[m])
            err, apart = against_twin(f"{label} call {i} map {m}", [pick(t) for t in got],
                                      [pick(t) for t in twin_out], pick(margins),
                                      pose_tol=pose_tol)
            max_err, parted = max(max_err, err), parted + apart
            if not apart:
                max_pose = max(max_pose, float((pick(got[0]) - pick(twin_out[0])).abs().max()))
    args = calls[-1]
    red = args[11]
    ms, plain_ms, chained = time_pair(lambda: kernel(*args), lambda: twin(*args), plain_calls=5)
    device_ms = graph_ms(lambda: kernel(*args))
    rounds_ms = statistics.median(time_ms(lambda: yardstick(*args), 20))
    poses = visited_poses(loop, score, args)
    cells = refine_cells(args, poses, red)
    n_w = int((args[2] != 0).sum())
    n_m = args[0].shape[0] if args[0].dim() == 3 else 1
    n_bytes = 4 * (cells + 2 * n_w + args[2].numel() + n_m * (2 + 3 + 3 + 1 + args[9]))
    per = grad_ops(red) if name == "gradient_refine" else (
        OVERLAP_OPS_PER_POINT if red.kind == "bilinear" else reducer_ops(red))
    n_poses = poses.shape[-2]
    n_ops = per * n_poses * n_w
    b_ms, by = bound_ms(n_bytes, n_ops)
    shape = (f"M={n_m} " if args[0].dim() == 3 else "") + (
        f"R'={args[1].shape[-2]} {args[0].shape[-2]}x{args[0].shape[-1]}, {args[9]} iterations, "
        f"{variant_name(red) if red.kind != 'bilinear' else 'bilinear'}")
    print(f"{name} [{label}]: {len(calls)} kept calls equal to {yardstick.__name__} bit for bit "
          f"(and single-map launches); vs plain twin max|diff| {max_err:.3e} (tol {TOL:g}), "
          f"poses {max_pose:.3e} m apart, {parted} parted after a decision closer than "
          f"{KNIFE_EDGE:g}; at {shape}: "
          f"{device_ms:.5f} ms on the device (50 launches replayed from a CUDA graph), a call "
          f"{ms:.4f} ms, chained {chained:.4f} ms; the yardstick {rounds_ms:.4f} ms a call; plain "
          f"twin {plain_ms:.4f} ms; bound {b_ms:.7f} ms by {by} ({n_bytes} B: {cells} tap cells; "
          f"{n_ops} operations over {n_poses} poses a map); {smi}", flush=True)
    return {
        "name": f"{name} {label}", "route": "cuda",
        "source": f"slam_constructor_tpu_torch/csrc/{name}.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "refines": "slam_constructor_tpu/ops/matchers.py:"
                   + ("217" if name == "gradient_refine" else "112"),
        "launches": launches, "max_abs_err": max_err, "max_pose_diff_m": max_pose,
        "cases_parted_from_twin": parted,
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device_ms,
        "rounds_ms": rounds_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def grad_entry(label, args, launches, smi):
    """``overlap_score_grad`` with a reducer, one map or M, at a refine's
    start poses (``args`` a kept refine call): the score with
    ``overlap_score(_batched)``'s bits and within 2e-6 of its twin, the
    gradient within 1e-5 x max(1, |g|) of the twin on the beams clear of
    the reducer's kinks (0 exactly where the score is flat), M maps equal
    to single-map launches; timed. Returns the `kernels` entry."""
    from slam_constructor_tpu_torch.ops import kernels

    v, pts, beam_w, origin, pose, scale, unknown = args[:7]
    red = args[11]
    poses = pose[..., None, :].contiguous()
    call = (v, poses, pts, beam_w, origin, scale, unknown, red)
    score, grad = kernels.overlap_score_grad(*call)
    plain = (kernels.overlap_score_batched if v.dim() == 3 else kernels.overlap_score)(*call)
    want_s, _ = kernels.overlap_score_grad_ref(*call)
    clear = kernels.clear_of_kinks(poses, pts, origin, scale, KINK_MARGIN, red)
    masked = (v, poses, pts, (beam_w * clear).contiguous(), origin, scale, unknown, red)
    _, g_k = kernels.overlap_score_grad(*masked)
    _, g_t = kernels.overlap_score_grad_ref(*masked)
    torch.cuda.synchronize()
    s_err = float((score - want_s).abs().max())
    g_err = float(((g_k - g_t).abs() / g_t.norm(dim=-1, keepdim=True).clamp(min=1.0)).max())
    check(torch.equal(score, plain), f"overlap_score_grad [{label}]: not the score's bits")
    check(s_err <= TOL and g_err <= GRAD_TOL, f"overlap_score_grad [{label}] disagrees with "
                                              f"its twin: {s_err}, {g_err}")
    check(not red.flat or torch.equal(grad, torch.zeros_like(grad)),
          f"overlap_score_grad [{label}]: a flat score's gradient is not 0")
    if v.dim() == 3:
        singles = [kernels.overlap_score_grad(*(t[m] for t in call[:5]), *call[5:])
                   for m in range(v.shape[0])]
        check(all(torch.equal(bits(a), bits(torch.stack(b))) for a, b in
                  zip((score, grad), zip(*singles))),
              f"overlap_score_grad [{label}]: M maps differ from single-map launches")
    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_grad(*call),
                                      lambda: kernels.overlap_score_grad_ref(*call))
    device_ms = graph_ms(lambda: kernels.overlap_score_grad(*call))
    n_m = v.shape[0] if v.dim() == 3 else 1
    cells = refine_cells(args, poses, red)
    n_w = int((beam_w != 0).sum())
    n_bytes = 4 * (cells + poses.numel() + 2 * n_w + beam_w.numel() + 2 * n_m + 4 * n_m)
    n_ops = grad_ops(red) * n_w
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score_grad [{label}]: {'M=' + str(n_m) + ' ' if v.dim() == 3 else ''}K=1 "
          f"R'={pts.shape[-2]} {v.shape[-2]}x{v.shape[-1]}: the score overlap_score's bits, "
          f"{s_err:.3e} from the twin (tol {TOL:g}), the gradient {g_err:.3e} x max(1, |g|) "
          f"(tol {GRAD_TOL:g}, {int((~clear).sum())} beams near a kink at weight 0); "
          f"{device_ms:.5f} ms on the device (graph replay), a call {ms:.4f} ms, chained "
          f"{chained:.4f} ms; twin {plain_ms:.4f} ms; bound {b_ms:.7f} ms by {by} ({n_bytes} B, "
          f"{n_ops} operations); {smi}", flush=True)
    return {
        "name": f"overlap_score_grad {label}", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score_grad.cu",
        "replaces": "slam_constructor_tpu/ops/scoring.py:358",
        "differentiates": "slam_constructor_tpu/ops/matchers.py:230",
        "launches": launches, "max_abs_err": max(s_err, float((g_k - g_t).abs().max())),
        "ms": ms, "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device_ms,
        "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def m3rsm_slot_entries(label, searches, builds, launches, smi):
    """M3RSM over the RBPF's P windows: ``m3rsm_search`` (a request a
    window) bit for bit ``m3rsm_search_levels`` and within 2e-6 of its twin
    where the poses agree; ``m3rsm_pyramid`` over the P windows bit for bit
    its twin; both timed. Returns the two `kernels` entries."""
    from slam_constructor_tpu_torch.ops import kernels

    err = 0.0
    for i, a in enumerate(searches):
        got, levels, twin = (kernels.m3rsm_search(a), kernels.m3rsm_search_levels(a),
                             kernels.m3rsm_search_ref(a))
        torch.cuda.synchronize()
        check(all(torch.equal(bits(x), bits(y)) for x, y in zip(got, levels)),
              f"m3rsm_search [{label} call {i}] differs from the level launches")
        agree = ~(got[0] != twin[0]).any(-1)
        if bool(agree.any()):
            err = max(err, float((got[1] - twin[1]).abs()[agree].max()))
    check(err <= TOL, f"m3rsm_search [{label}]: {err} from its twin")
    a = searches[-1]
    ms, plain_ms, chained = time_pair(lambda: kernels.m3rsm_search(a),
                                      lambda: kernels.m3rsm_search_ref(a), plain_calls=3)
    device_ms = graph_ms(lambda: kernels.m3rsm_search(a), n=20)
    n_bytes, n_ops = search_work(a)
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"m3rsm_search [{label}]: {len(searches)} kept calls of B={a.prior.shape[0]} requests "
          f"equal to the level launches bit for bit, prob within {err:.3e} of the twin where "
          f"the poses agree; {device_ms:.5f} ms on the device (graph replay), a call {ms:.4f} "
          f"ms, chained {chained:.4f} ms; twin {plain_ms:.4f} ms; bound {b_ms:.6f} ms by {by} "
          f"({n_bytes} B, {n_ops} operations); {smi}", flush=True)
    search = {"name": f"m3rsm_search {label}", "route": "cuda",
              "source": "slam_constructor_tpu_torch/csrc/m3rsm_match.cu",
              "replaces": "slam_constructor_tpu/ops/m3rsm.py:210",
              "launches": launches["m3rsm_search"], "max_abs_err": err, "ms": ms,
              "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device_ms,
              "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    for i, b in enumerate(builds):
        got, want = kernels.m3rsm_pyramid(*b), kernels.m3rsm_pyramid_ref(*b)
        torch.cuda.synchronize()
        check(all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want)),
              f"m3rsm_pyramid [{label} call {i}] differs from its twin")
    b = builds[-1]
    ms, plain_ms, chained = time_pair(lambda: kernels.m3rsm_pyramid(*b),
                                      lambda: kernels.m3rsm_pyramid_ref(*b))
    device_ms = graph_ms(lambda: kernels.m3rsm_pyramid(*b))
    n_cells = b[0].numel()
    stored = sum(p.numel() for p in kernels.m3rsm_pyramid(*b))
    b_ms, by = bound_ms(pyramid_bytes(n_cells, stored), pyramid_ops(n_cells, stored))
    print(f"m3rsm_pyramid [{label}]: {len(builds)} kept builds of {tuple(b[0].shape)} at {b[2]} "
          f"levels equal to the twin bit for bit; {device_ms:.5f} ms on the device, a call "
          f"{ms:.4f} ms, chained {chained:.4f} ms; twin {plain_ms:.4f} ms; bound {b_ms:.6f} ms by "
          f"{by}; {smi}", flush=True)
    pyramid = {"name": f"m3rsm_pyramid {label}", "route": "cuda",
               "source": "slam_constructor_tpu_torch/csrc/m3rsm_pyramid.cu",
               "replaces": "slam_constructor_tpu/ops/m3rsm.py:68",
               "launches": launches["m3rsm_pyramid"], "max_abs_err": 0.0, "ms": ms,
               "plain_ms": plain_ms, "chained_ms": chained, "device_ms": device_ms,
               "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    return [search, pyramid]


def phase_slot_kernels(slot_kept, loop_kept, joint_kept, cli_kept, launches, smi):
    """The kernels of slice 6d's paths on calls kept from them: the
    gradient refine at the general overlap (tiny_refined's CLI at extent
    1.5, one map; the RBPF's 30 windows at extent 2; the loop closer's
    submaps at extent 1.5) and with the joint refine's bilinear default, the
    hill climb over the RBPF's 30 windows and the loop closer's submaps, the
    pose gradient at those reducers, M3RSM over the RBPF's windows. Each
    entry carries its launches on the path it was kept from."""
    entries = []
    refines = [
        ("gradient_refine", "overlap e1.5 w1, one map (cli tiny_refined)", cli_kept,
         launches["cli tiny_refined overlap e1.5"]["gradient_refine"]),
        ("gradient_refine", "overlap e2 w2, M=30 (gmapping gradient)",
         slot_kept["gradient_refine"]["gmapping gradient"],
         launches["gmapping gradient"]["gradient_refine"]),
        ("gradient_refine", "overlap e2 w2, M=30 (gmapping monte_carlo+gradient)",
         slot_kept["gradient_refine"]["gmapping monte_carlo+gradient"],
         launches["gmapping monte_carlo+gradient"]["gradient_refine"]),
        ("gradient_refine", "overlap e1.5 w1, M submaps (full gradient)",
         loop_kept["full gradient"]["gradient_refine"],
         launches["full gradient"]["gradient_refine"]),
        ("gradient_refine", "bilinear, M=8 (joint_refine gradient)", joint_kept["gradient_refine"],
         launches["joint_refine gradient"]["gradient_refine"]),
        ("hill_climb", "M=30 (gmapping monte_carlo+hill_climbing)",
         slot_kept["hill_climb"]["gmapping monte_carlo+hill_climbing"],
         launches["gmapping monte_carlo+hill_climbing"]["hill_climb"]),
        ("hill_climb", "M submaps (full hill_climbing)",
         loop_kept["full hill_climbing"]["hill_climb"],
         launches["full hill_climbing"]["hill_climb"]),
    ]
    for name, label, calls, n in refines:
        entries.append(refine_entry(name, label, calls, n, smi))
    grads = [("overlap e1.5 w1, one map", cli_kept[-1]),
             ("overlap e2 w2, M=30", slot_kept["gradient_refine"]["gmapping gradient"][-1])]
    for label, args in grads:
        entries.append(grad_entry(label, args, 0, smi))
    m3 = "gmapping m3rsm"
    entries += m3rsm_slot_entries("P=30 windows of 160^2 (gmapping m3rsm)",
                                  slot_kept["m3rsm_search"][m3], slot_kept["m3rsm_pyramid"][m3],
                                  launches[m3], smi)
    return entries


# --- slice 7: the multi-device layer ------------------------------------------

#: scans of the bench sequence that the world-1 group's paths run, after a
#: warm-up of PAR_WARMUP scans (the first collectives set up NCCL)
PAR_SCANS = 64
PAR_WARMUP = 4
#: the world-1 group's runs against the unsharded port on the card: with
#: one rank the all-reduces add nothing, so the same draws give the same
#: poses, weights and maps; 1e-6 leaves room for a sum taken in another order
PAR_TOL = 1e-6
#: the Schur elimination against the direct Cholesky solve (another
#: factorisation of a float32 system)
SCHUR_TOL = 1e-4
#: f32 operations of the ownership test of a weighted (pose, beam) pair
#: beyond the endpoint's row (2 products, 2 sums, a difference, a division:
#: PARTIAL_ROW_OPS) and its floor: the clamp and the two comparisons
PARTIAL_ROW_OPS = 6
PARTIAL_TEST_OPS = 2 + 2
#: the row partitions the partial score is held over
PARTIAL_SPLITS = (2, 4, 8)


def reducer_label(red) -> str:
    return "bilinear" if red.kind == "bilinear" else variant_name(red)


def reducer_scoring(red):
    """The ``ScoringConfig`` whose reducer is ``red`` (a kernels.Reducer)."""
    from slam_constructor_tpu_torch.ops import scoring

    if red.kind == "bilinear":
        return scoring.ScoringConfig(reducer="overlap", window=1)
    return scoring.ScoringConfig(reducer=red.kind, window=red.radius, overlap_extent=red.extent)


def pair_tap_cells(h, w, poses, pts, origin, scale, red) -> int:
    """The distinct cells of an h x w plane that the taps of the (pose,
    endpoint) pairs ``poses`` f32[N, 3], ``pts`` f32[N, 2] read."""
    c, s = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
    x = (poses[:, 0] + c * pts[:, 0] - s * pts[:, 1] - origin[0]) / scale
    y = (poses[:, 1] + s * pts[:, 0] + c * pts[:, 1] - origin[1]) / scale
    if red.kind == "bilinear":
        fy, fx = torch.floor(y - 0.5), torch.floor(x - 0.5)
        d = torch.arange(2, device=poses.device, dtype=torch.float32)
    else:
        fy, fx = torch.floor(y), torch.floor(x)
        n = red.radius if red.kind != "obstacle" else 0
        d = torch.arange(-n, n + 1, device=poses.device, dtype=torch.float32)
    rows = fy[:, None, None] + d[None, :, None]
    cols = fx[:, None, None] + d[None, None, :]
    ok = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return int((rows * w + cols)[ok].to(torch.int64).unique().numel())


def partial_work(h, w, poses, pts, beam_w, origin, scale, row0, row1, red):
    """(bytes, operations) one ``overlap_score_partial`` call must move and
    do: the cells the owned beams' taps read, each input once, (num, den)
    a pose; the ownership test of every weighted (pose, beam) pair and the
    reducer's arithmetic on the owned ones. An owned pair's row is the
    reducer's (its pose transform and cell units), and so is the floor of
    that row where the reducer takes it (every reducer but the bilinear
    taps, which floor y - 0.5): the test adds the clamp and the comparisons
    there, the floor too for the bilinear taps."""
    q = pts[beam_w != 0]
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    y = (poses[:, 1:2] + s * q[:, 0] + c * q[:, 1] - origin[1]) / scale
    fy = torch.floor(y).clamp(0, h - 1)
    k_idx, r_idx = ((fy >= row0) & (fy < row1)).nonzero(as_tuple=True)
    cells = pair_tap_cells(h, w, poses[k_idx], q[r_idx], origin, scale, red)
    n_bytes = 4 * (cells + poses.numel() + 2 * q.shape[0] + beam_w.numel() + 2) + 8 * poses.shape[0]
    n_own = int(k_idx.numel())
    n_not = poses.shape[0] * q.shape[0] - n_own
    if red.kind == "bilinear":
        per_owned = OVERLAP_OPS_PER_POINT + 1 + PARTIAL_TEST_OPS
    else:
        per_owned = reducer_ops(red) + PARTIAL_TEST_OPS
    return n_bytes, (PARTIAL_ROW_OPS + 1 + PARTIAL_TEST_OPS) * n_not + per_owned * n_own


def partial_mean(sums):
    """A band's weighted mean num / max(den, 1e-9) a pose."""
    return sums[:, 0] / sums[:, 1].clamp(min=1e-9)


def partial_bands(plane, red, d):
    """The d row bands of ``plane`` with the rows their owned beams' taps
    read: (band, g0, row0, row1) each."""
    from slam_constructor_tpu_torch.ops import kernels

    h = plane.shape[0]
    need = max(kernels._partial_need(red), 1)
    bounds = [h * i // d for i in range(d + 1)]
    return [(plane[max(r0 - need, 0):min(r1 + need, h)].contiguous(), max(r0 - need, 0), r0, r1)
            for r0, r1 in zip(bounds[:-1], bounds[1:])]


def phase_partial_kernel(dev, scans, gt, smi):
    """`overlap_score_partial` (a rank's share of the score of a plane
    sharded by rows) against its plain twin on every band of 2, 4 and 8
    row partitions, every reducer, at the tiny path's shapes (a 256^2 map
    after 20 bench scans, K = 64, 360 beams) and with candidates half off
    the map; the bands' sums, divided, against `overlap_score` (2e-6 x
    max(1, |s|)); then timed on the first band of two (the halo path's
    call; replayed from a CUDA graph, a call, chained) beside its twin and
    its bound. Returns the `kernels` entry."""
    from slam_constructor_tpu_torch.models import tiny
    from slam_constructor_tpu_torch.models.engine import init_state
    from slam_constructor_tpu_torch.ops import kernels, raycast, scoring

    cfg = tiny.tiny_config(map_size=MAP)
    gm = init_state(cfg, dev).gm
    for i in range(0, 40, 2):
        gm = raycast.insert_scan(gm, cfg.cell_model, gt[i], scans[i], cfg.beam)
    view = scoring.MapView.of(gm, cfg.cell_model)
    g = torch.Generator(device=dev).manual_seed(11)
    pose = gt[40]
    cand = pose + torch.randn((64, 3), generator=g, device=dev) * torch.tensor(
        [0.3, 0.3, 0.1], device=dev)
    half_off = pose + torch.randn((64, 3), generator=g, device=dev) * torch.tensor(
        [6.0, 6.0, 3.0], device=dev) + torch.tensor([9.0, 0.0, 0.0], device=dev)
    max_err = 0.0
    for red in [kernels.BILINEAR, *reducer_variants()]:
        prep = scoring.prepare(view, scans[40], reducer_scoring(red))
        for label, poses in (("K=64", cand), ("half off the map", half_off), ("K=1", cand[:1])):
            whole = kernels.overlap_score(prep.plane, poses, prep.pts, prep.beam_w, prep.origin,
                                          prep.scale, prep.unknown, red)
            for d in PARTIAL_SPLITS:
                sums = torch.zeros((poses.shape[0], 2), device=dev)
                for band, g0, r0, r1 in partial_bands(prep.plane, red, d):
                    args = (band, g0, MAP, poses, prep.pts, prep.beam_w, prep.origin,
                            prep.scale, prep.unknown, r0, r1, red)
                    got = kernels.overlap_score_partial(*args)
                    twin = kernels.overlap_score_partial_ref(*args)
                    # the sums (num, den) relative to their size; the score
                    # num / den (a band's mean) as an absolute difference
                    rel = float(((got - twin).abs() / twin.abs().clamp(min=1.0)).max())
                    err = float((partial_mean(got) - partial_mean(twin)).abs().max())
                    check(rel <= TOL and err <= TOL,
                          f"overlap_score_partial [{reducer_label(red)}, {label}, rows {r0}-{r1}]"
                          f": sums {rel} (relative), mean {err} from its twin")
                    check(torch.equal(kernels.overlap_score_partial(*args), got),
                          "overlap_score_partial: two launches differ")
                    max_err = max(max_err, err)
                    sums += got
                score = sums[:, 0] / sums[:, 1].clamp(min=1e-9)
                gap = float(((score - whole).abs() / whole.abs().clamp(min=1.0)).max())
                check(gap <= TOL, f"overlap_score_partial: {d} bands' sums {gap} from overlap_score")
            # one band that holds the whole plane: every beam in the group's
            # order, so (num, den) give overlap_score's bits
            whole_band = kernels.overlap_score_partial(prep.plane, 0, MAP, poses, prep.pts,
                                                       prep.beam_w, prep.origin, prep.scale,
                                                       prep.unknown, 0, MAP, red)
            mean = whole_band[:, 0] / torch.fmax(whole_band[:, 1],
                                                 torch.full_like(whole_band[:, 1], 1e-9))
            check(torch.equal(bits(mean), bits(whole)),
                  f"overlap_score_partial [{reducer_label(red)}, {label}]: the whole plane as one "
                  f"band does not give overlap_score's bits")
        print(f"overlap_score_partial [{reducer_label(red)}]: every band of {PARTIAL_SPLITS} row "
              f"partitions within {TOL:g} of its twin (its sums relative, its mean absolute), the "
              f"bands' sums within {TOL:g} x max(1, |s|) of overlap_score, one band of the whole "
              f"plane its bits (K = 64, 64 half off the map, 1)", flush=True)
    prep = scoring.prepare(view, scans[40], reducer_scoring(kernels.BILINEAR))
    band, g0, r0, r1 = partial_bands(prep.plane, kernels.BILINEAR, 2)[0]
    args = (band, g0, MAP, cand, prep.pts, prep.beam_w, prep.origin, prep.scale, prep.unknown,
            r0, r1)
    ms, plain_ms, chained = time_pair(lambda: kernels.overlap_score_partial(*args),
                                      lambda: kernels.overlap_score_partial_ref(*args))
    device_ms = graph_ms(lambda: kernels.overlap_score_partial(*args))
    n_bytes, n_ops = partial_work(MAP, MAP, cand, prep.pts, prep.beam_w, prep.origin, prep.scale,
                                  r0, r1, kernels.BILINEAR)
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"overlap_score_partial K=64 R=360, rows {r0}-{r1} of 256 (+1 halo row): device "
          f"{device_ms * 1e3:.2f} us (50 launches replayed from a CUDA graph), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 100 calls each, CUDA events), kernel "
          f"{chained:.4f} ms a launch over 200 back to back; bound {b_ms:.7f} ms by {by} "
          f"({n_bytes} B, {n_ops} operations) on {smi}; no single PyTorch call computes it",
          flush=True)
    return {
        "name": "overlap_score_partial", "route": "cuda",
        "source": "slam_constructor_tpu_torch/csrc/overlap_score.cu",
        "replaces": "slam_constructor_tpu/ops/pallas_kernels.py:73",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "chained_ms": chained,
        "device_ms": device_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
    }


def steps_agree(name, got, want, tol=PAR_TOL):
    """Per-step (ancestors, poses, log-weights) of two runs: ancestors
    equal, the rest within ``tol``; returns the largest differences."""
    worst = [0.0, 0.0]
    for i, ((a1, p1, w1), (a2, p2, w2)) in enumerate(zip(got, want)):
        check(torch.equal(a1, a2), f"{name}: ancestors differ at scan {i}")
        dp = p1 - p2
        dp = torch.cat([dp[:, :2], torch.atan2(torch.sin(dp[:, 2:]), torch.cos(dp[:, 2:]))], 1)
        worst = [max(worst[0], float(dp.abs().max())), max(worst[1], float((w1 - w2).abs().max()))]
    check(worst[0] <= tol and worst[1] <= tol,
          f"{name}: poses {worst[0]}, log-weights {worst[1]} from the unsharded port (tol {tol})")
    return worst


def run_rbpf_steps(step, state, scans, odom, draws=None):
    """Steps of an RBPF step function over ``scans`` (drawing from the
    state's key unless ``draws`` are handed in); returns the state,
    (ancestors, poses, log-weights) a step and the seconds."""
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(len(scans)):
        state, idx = step(state, scans[i], odom[i], None if draws is None else draws[i])
        out.append((idx, state.poses, state.log_weights))
    torch.cuda.synchronize()
    return state, out, time.perf_counter() - t0


def phase_parallel(dev, scans, odom, gt, fscans, fodom, fgt, smi):
    """The multi-device layer in an NCCL group of world size 1 set up in
    this process (127.0.0.1, a free port; one H100 cannot host two NCCL
    ranks), each path against the unsharded port on the card: the
    ``distributed`` preset (its full width, ``GMappingConfig()``), the
    ``ep_cow`` step and the ``ep2d`` 1 x 1 step at the copy-on-write cell's
    config, the row-sharded block map's inserts and scores, the halo and
    beam-sharded scores at every reducer, ``distributed_optimize`` on the
    full path's graph, a heartbeat and a ``RecoveryLoop`` round trip. The
    group is torn down at the end. Returns the launches of each path."""
    import torch.distributed as dist

    from slam_constructor_tpu_torch.models import gmapping, posegraph
    from slam_constructor_tpu_torch.ops import blockmap, cells, kernels, raycast, scoring
    from slam_constructor_tpu_torch.parallel import blockshard, dist_ba, ep2d, ep_cow, halo
    from slam_constructor_tpu_torch.parallel import mesh as meshlib
    from slam_constructor_tpu_torch.parallel import multihost
    from slam_constructor_tpu_torch.utils import config as cfglib

    n = PAR_SCANS
    s_, o_ = scans[:n], odom[:n]
    meshlib.init(0, 1, torch.device("cuda", 0), f"tcp://127.0.0.1:{meshlib.free_port()}")
    launches = {}
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"parallel: group {dist.get_backend()} of {dist.get_world_size()}")
        print(f"parallel: an NCCL group of world size 1 on {smi}", flush=True)

        # the distributed preset at its full width, against the unsharded step
        cfg, st, step = cfglib.preset("distributed")()
        check(st.poses.device.type == "cuda", "distributed preset: state not on the card")
        run_rbpf_steps(step, st, s_[:PAR_WARMUP], o_[:PAR_WARMUP])  # the communicators
        cfg, st, step = cfglib.preset("distributed")()
        st.poses = gt[0].expand(cfg.n_particles, 3).clone()
        ref = gmapping.init_state(cfg)
        ref.poses = st.poses.clone()
        reset_launches()
        # both from PRNGKey(0), the preset's and init_state's default key
        _, want, secs_ref = run_rbpf_steps(functools.partial(gmapping.gmapping_step, cfg), ref,
                                           s_, o_)
        want_launches = read_launches()
        reset_launches()
        st, got, secs = run_rbpf_steps(step, st, s_, o_)
        launches["distributed preset"] = read_launches()
        worst = steps_agree("distributed preset", got, want)
        check(launches["distributed preset"] == want_launches
              and want_launches["mc_match_batched"] == n,
              f"distributed preset: launches {launches['distributed preset']}, the unsharded "
              f"step's {want_launches}")
        print(f"distributed preset ({cfg.n_particles} particles, whole {cfg.map_height}^2 maps, "
              f"{cfg.matcher_cfg.batch} x {cfg.matcher_cfg.rounds} rounds), {n} scans: "
              f"{n / secs:.1f} scans/s sharded, {n / secs_ref:.1f} unsharded on {smi}; ancestors "
              f"equal, poses {worst[0]:.2e}, log-weights {worst[1]:.2e} from the unsharded step "
              f"(tol {PAR_TOL:g}); launches {launches['distributed preset']}", flush=True)

        # the copy-on-write pools a rank, and 1 x 1 of particles x bands
        ccfg = cow_config()
        draws = rbpf_draws(ccfg, n).to(dev)
        ref = gmapping.init_state(ccfg)
        ref.poses = gt[0].expand(ccfg.n_particles, 3).clone()
        reset_launches()
        ref, want, secs_ref = run_rbpf_steps(functools.partial(gmapping.gmapping_step, ccfg), ref,
                                             s_, o_, draws)
        want_launches = read_launches()
        want_planes = ep_cow.particle_planes(ref.gm, ccfg.cell_model)
        chips = meshlib.flat_mesh("chips")
        grid = meshlib.grid_mesh((1, 1), ep2d.AXES)
        for name, init, make, maps in (
                ("ep_cow", lambda: ep_cow.init_ep_state(ccfg, chips, "chips",
                                                        ccfg.tile_capacity, dev),
                 lambda: ep_cow.make_ep_step(ccfg, chips, "chips"), lambda g_: g_),
                ("ep2d 1x1", lambda: ep2d.init_ep2d_state(ccfg, grid, ccfg.tile_capacity, dev),
                 lambda: ep2d.make_ep2d_step(ccfg, grid), lambda g_: g_.band)):
            run_rbpf_steps(make(), init(), s_[:PAR_WARMUP], o_[:PAR_WARMUP], draws)
            st = init()
            st.poses = gt[0].expand(ccfg.n_particles, 3).clone()
            reset_launches()
            st, got, secs = run_rbpf_steps(make(), st, s_, o_, draws)
            launches[name] = read_launches()
            worst = steps_agree(name, got, want)
            planes = ep_cow.particle_planes(maps(st.gm), ccfg.cell_model)
            gap = float((planes - want_planes).abs().max())
            check(gap <= PAR_TOL, f"{name}: maps {gap} from the unsharded copy-on-write step")
            check(launches[name] == want_launches,
                  f"{name}: launches {launches[name]}, the unsharded step's {want_launches}")
            check(not bool(maps(st.gm).overflow), f"{name}: the pool overflowed")
            print(f"{name} at the copy-on-write cell ({ccfg.n_particles} particles, "
                  f"{ccfg.tile_capacity} blocks), {n} scans: {n / secs:.1f} scans/s, the "
                  f"unsharded step {n / secs_ref:.1f}, on {smi}; "
                  f"ancestors equal, poses {worst[0]:.2e}, log-weights {worst[1]:.2e}, maps "
                  f"{gap:.2e} from the unsharded step; launches {launches[name]}", flush=True)

        # the block map sharded by tile rows: inserts and scores
        model, beam = cells.BayesAvgCell(), raycast.BeamConfig()
        sc = scoring.ScoringConfig(reducer="overlap", window=1)
        sbm = blockshard.make_sharded_block_map(model, 8, 8, 64, chips, "chips", 32, 0.1,
                                                device=dev)
        bm = blockmap.make_block_map(model, 8, 8, 64, 32, 0.1, device=dev)
        g = torch.Generator(dev).manual_seed(5)
        cands = [gt[i] + torch.randn((64, 3), generator=g, device=dev) * 0.2 for i in range(n)]
        reset_launches()
        sharded = []
        for i in range(n):
            blockshard.insert_scan(sbm, model, gt[i], s_[i], beam)
            sharded.append(blockshard.score_poses(sbm, model, s_[i], cands[i], sc, chips))
        torch.cuda.synchronize()
        launches["blockshard"] = read_launches()
        gap = 0.0
        for i in range(n):
            blockmap.insert_scan(bm, model, gt[i], s_[i], beam)
            view = scoring.MapView.of(blockmap.extract_window(bm, model, torch.zeros(2, device=dev),
                                                              8, 8), model)
            whole = scoring.score_poses(view, s_[i], cands[i], sc)
            gap = max(gap, float(((sharded[i] - whole).abs() / whole.abs().clamp(min=1.0)).max()))
        plane = blockshard.gather_value_plane(sbm, model, chips)
        plane_gap = float((plane - torch.where(view.known, view.occ, 0.5)).abs().max())
        check(torch.equal(sbm.band.table, bm.table) and torch.equal(sbm.band.n_alloc, bm.n_alloc),
              "blockshard: tables or allocation differ from the unsharded tiled map")
        check(gap <= TOL and plane_gap <= PAR_TOL,
              f"blockshard: scores {gap}, value plane {plane_gap} from the unsharded map")
        check(launches["blockshard"] == expect(pool_prepare=n, pool_insert=n,
                                               overlap_score_partial=n),
              f"blockshard: launches {launches['blockshard']}")
        print(f"blockshard (8 x 8 tiles of 32, {int(bm.n_alloc)} blocks), {n} inserts and "
              f"scores of K = 64: scores within {gap:.2e} x max(1, |s|), the value plane "
              f"{plane_gap:.2e} of the unsharded tiled map's, tables equal; launches "
              f"{launches['blockshard']}", flush=True)

        # the halo and beam-sharded scores of the tiled map's view, every reducer
        reset_launches()
        gap = 0.0
        for red in [kernels.BILINEAR, *reducer_variants()]:
            c = reducer_scoring(red)
            whole = scoring.score_poses(view, s_[-1], cands[-1], c)
            for fn in (halo.sharded_score_poses, halo.beam_sharded_score_poses):
                got = fn(view, s_[-1], cands[-1], c, chips, "chips")
                gap = max(gap, float(((got - whole).abs() / whole.abs().clamp(min=1.0)).max()))
        launches["halo"] = read_launches()
        n_red = 1 + len(REDUCER_VARIANTS)
        check(gap <= TOL, f"halo: sharded scores {gap} from score_poses")
        check(launches["halo"]["overlap_score_partial"] == 2 * n_red,
              f"halo: launches {launches['halo']}")
        print(f"halo: row- and beam-sharded scores at {n_red} reducers within {gap:.2e} x "
              f"max(1, |s|) of score_poses; launches {launches['halo']}", flush=True)

        # the pose graph of the full path, solved over the group
        e, *_ = run_full_path(full_config(), fscans, fodom, fgt, 0)
        gcfg, graph = e.cfg.graph, e.graph
        hosts = meshlib.make_mesh()
        local = posegraph.optimize(gcfg, graph).kf_poses
        direct = dist_ba.distributed_optimize(gcfg, graph, hosts, "hosts").kf_poses
        split = max(int(graph.n_kf) // 2, 1)
        schur = dist_ba.distributed_optimize(gcfg, graph, hosts, "hosts", schur_split=split).kf_poses
        d_gap = float((direct - local).abs().max())
        s_gap = float((schur - direct).abs().max())
        check(bool(torch.isfinite(direct).all()) and d_gap <= 1e-5 and s_gap <= SCHUR_TOL,
              f"distributed_optimize: {d_gap} from optimize, Schur {s_gap} from direct")
        print(f"distributed_optimize on the full path's graph ({int(graph.n_kf)} keyframes, "
              f"{int(graph.n_edges)} edges): {d_gap:.2e} from posegraph.optimize (tol 1e-5), "
              f"Schur at {split} keyframes {s_gap:.2e} from the direct solve (tol {SCHUR_TOL:g})",
              flush=True)

        # liveness and recovery
        alive = multihost.heartbeat(hosts, "hosts", timeout_s=30.0)
        check(alive, "heartbeat: the one-rank group did not answer")
        cfg, st, step = cfglib.preset("distributed")()
        st.poses = gt[0].expand(cfg.n_particles, 3).clone()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_recovery",
                            "rbpf")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        loop = multihost.RecoveryLoop(path, save_every=16)

        def fresh():
            return {"state": st}

        for f in (path + ".npz", path + ".tmp.npz"):
            if os.path.exists(f):
                os.remove(f)
        run, resumed = loop.restore_or(fresh(), fresh)
        check(not resumed, "RecoveryLoop: a snapshot before the first tick")
        for i in range(16):
            run = {"state": step(run["state"], scans[i], odom[i])[0]}
            loop.tick(run)
        for i in range(16, 32):
            run = {"state": step(run["state"], scans[i], odom[i])[0]}
        back, resumed = multihost.RecoveryLoop(path, save_every=16).restore_or(fresh(), fresh)
        for i in range(16, 32):
            back = {"state": step(back["state"], scans[i], odom[i])[0]}
        same = resumed and all(torch.equal(getattr(back["state"], f), getattr(run["state"], f))
                               for f in ("poses", "log_weights", "step")) and bits(
            back["state"].key).equal(bits(run["state"].key)) and torch.equal(
            back["state"].gm.cells, run["state"].gm.cells)
        check(same, "RecoveryLoop: the resumed run differs from the unbroken one")
        print(f"heartbeat: {alive}; RecoveryLoop: the distributed preset saved after 16 scans, "
              f"restored and run 16 more equal to the unbroken run bit for bit", flush=True)
    finally:
        meshlib.shutdown()
    return launches


#: the card's int32 rate: 132 SMs x 64 int32 lanes x 1.98 GHz (Hopper issues
#: 64 int32 operations a clock an SM against 128 f32; the clock is the one
#: behind the f32 rate above, 132 x 128 x 2 x 1.98 GHz = 67 TFLOP/s)
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: int32 operations of one threefry2x32 hash (csrc/threefry.cu): the key
#: schedule's xor (2), the first two adds, then 5 x (4 rounds of an add, a
#: funnel-shift rotate and a xor, then 2 key adds and the round constant)
PRNG_HASH_OPS = 2 + 2 + 5 * (4 * 3 + 3)
#: f32 operations (an FMA counted as 2) of the uniform (the subtraction,
#: the FMA, the max), and of the normal transform after it: the square
#: of u (1), log1p's rational branch near 0 (34) or its logf branch (32),
#: erf_inv's z (1 below w = 5, the square root and an add (2) from there),
#: its 8 Horner steps (16) and two products (2)
PRNG_UNIFORM_FLOPS = 4
PRNG_LOG1P_FLOPS = {"rational": 34, "logf": 32}
PRNG_ERFINV_FLOPS = {"below 5": 1 + 16 + 2, "from 5": 2 + 16 + 2}


def prng_path_hashes(plan, roots):
    """The hashes that the plan's paths need: each distinct key once. A
    step from a prefix makes a key for each key of the prefix (an index) or
    ``n`` (``Each(n)``), so the prefixes are merged into a tree and each
    node counts its keys."""
    from slam_constructor_tpu_torch.ops import prng

    def count(paths, keys):
        hashes = 0
        for step in dict.fromkeys(p[0] for p in paths):
            made = keys * (step.n if isinstance(step, prng.Each) else 1)
            hashes += made + count([p[1:] for p in paths if p[0] == step and len(p) > 1], made)
        return hashes

    return count([tuple(d.path) for d in plan if d.path], roots)


def prng_normal_uniforms(key, d):
    """The uniforms on (nextafter(-1, 0), 1) that a normal or transform
    draw's elements transform (the plain version's, on the key's device)."""
    from slam_constructor_tpu_torch.ops import prng

    if d.kind == "normal":
        return prng.draw_ref(key, prng.Draw(d.path, "uniform", d.shape, prng.NORMAL_LO, 1.0))
    j = torch.arange(math.prod(d.shape), device=key.device) & 0x7FFFFF
    f = (j | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the fused multiply-add of the uniform, rounded once (exact in float64)
    u = (f.double() * 2.0 + prng.NORMAL_LO).float().clamp_min(prng.NORMAL_LO)
    return u.reshape(d.shape)


def prng_work(key, plan):
    """(bytes, int32 operations, f32 operations) that one ``prng_draws`` of
    ``plan`` from ``key`` needs: the root keys and the plan's records read,
    the outputs written; a hash for each distinct key of the paths
    (``prng_path_hashes``) and one for each leaf element of a bits, uniform
    or normal draw (a key is its path's last hash; a transform hashes
    nothing); the uniform's operations, and for a normal the branch of
    log1p and of erf_inv that this element takes (counted on the draws'
    own uniforms)."""
    from slam_constructor_tpu_torch.ops import prng

    roots = key.numel() // 2
    n_bytes = 8 * roots + 64 * len(plan)
    hashes = prng_path_hashes(plan, roots)
    flops = 0
    for d in plan:
        each = math.prod(s.n for s in d.path if isinstance(s, prng.Each))
        leaves = 1 if d.kind == "key" else math.prod(d.shape)
        elements = roots * each * leaves
        n_bytes += 4 * elements * (2 if d.kind == "key" else 1)
        hashes += elements if d.kind in ("bits", "uniform", "normal") else 0
        if d.kind in ("uniform", "normal", "transform"):
            flops += elements * PRNG_UNIFORM_FLOPS
        if d.kind in ("normal", "transform"):
            u = prng_normal_uniforms(key, d)
            x = -u * u
            near = int((x.abs() < prng._L1P_T).sum())
            below = int((prng.log1p_xla(x) > -5.0).sum())
            flops += elements + near * PRNG_LOG1P_FLOPS["rational"] + (
                elements - near) * PRNG_LOG1P_FLOPS["logf"] + below * PRNG_ERFINV_FLOPS[
                "below 5"] + (elements - below) * PRNG_ERFINV_FLOPS["from 5"]
    return n_bytes, hashes * PRNG_HASH_OPS, flops


def prng_bound_ms(key, plan):
    """The least time of a ``prng_draws``: the larger of its bytes over the
    memory rate, its int32 operations over the int32 rate and its f32
    operations over the f32 rate (separate units, so they may overlap)."""
    n_bytes, ops, flops = prng_work(key, plan)
    times = {"bytes": n_bytes / PEAK_BYTES_PER_S, "operations": max(
        ops / PEAK_INT32_OPS_PER_S, flops / PEAK_F32_FLOP_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, (n_bytes, ops, flops)


def hill_mc_refine_config():
    """The RBPF with a hill climb as its match and a Monte-Carlo refine of
    another shape: a refine that draws normals of its own."""
    from slam_constructor_tpu_torch.ops import matchers

    base = gmapping_config()
    sc = base.matcher_cfg.scoring
    return dataclasses.replace(
        base, matcher="hill_climbing", matcher_cfg=matchers.HillClimbingConfig(scoring=sc),
        refine_matcher="monte_carlo",
        refine_cfg=matchers.MonteCarloConfig(batch=16, rounds=4, scoring=sc))


def prng_plans(dev):
    """Every path's step plan (the engines' and the RBPFs', the synthetic
    sequence's) by name."""
    from slam_constructor_tpu_torch.models import engine, gmapping, tiny, viny
    from slam_constructor_tpu_torch.ops import prng
    from slam_constructor_tpu_torch.utils import config as cfglib

    def rbpf(cfg):
        return (gmapping.NEXT_KEY, *(d for d in gmapping.draw_plan(cfg) if d is not None))

    plans = {name: engine.step_plan(cfg) for name, cfg in (
        ("tiny", tiny.tiny_config(map_size=MAP)), ("viny", viny.viny_config(map_size=MAP)),
        ("full tracker", full_config().tracking),
        ("viny_m3rsm", viny.viny_m3rsm_config(map_size=MAP)),
        ("tiny_refined (MC + gradient)", cfglib.engine_config_from(cfglib.load_properties(
            "configs/tiny_refined.properties"))))}
    for name, cfg in (("gmapping", gmapping_config()),
                      ("gmapping preset", gmapping.GMappingConfig()),
                      ("gmapping improved", dataclasses.replace(
                          gmapping_config(), proposal="improved", min_match_prob=0.3)),
                      ("gmapping hill + MC refine", hill_mc_refine_config())):
        plans[name] = rbpf(cfg)
    t, r = N_SCANS, N_BEAMS
    plans["synthetic sequence (CLI)"] = (prng.Draw((t,), "normal", (t, 3)),
                                         prng.Draw((prng.Each(t),), "normal", (r,)))
    return plans


#: how close a key's ATE on the card must come to the reference's on the
#: same key to count as paired (phase 51's report)
PAIRED_ATE = 0.005


def phase_ate_by_key(paths):
    """Each path from the reference's keys ``PRNGKey(0..4)``: the port's ATE
    (no alignment) beside the reference's from the same key on the same
    sequence (``reference_ate.py --keys 5``). Since the port draws what the
    reference draws from a key, the two are paired; they part only where a
    knife-edge decision flips (ROADMAP trap i). ``paths``: (name, run(seed)
    -> trajectory, ground truth, the reference's ATE by key)."""
    from slam_constructor_tpu_torch.utils import evaluate

    out = {}
    for name, run, gt, reference in paths:
        port = [float(evaluate.ate(run(k), gt, align=False)) for k in range(len(reference))]
        check(all(math.isfinite(a) for a in port), f"{name}: a non-finite ATE by key")
        gaps = [p - r for p, r in zip(port, reference)]
        print(f"{name} ATE by key (port on the card | the reference on a CPU, the same key): "
              + ", ".join(f"key {k} {p:.5f} | {r:.5f}" for k, (p, r) in
                          enumerate(zip(port, reference)))
              + f"; paired difference {min(gaps):+.5f} to {max(gaps):+.5f} m, median "
              f"{statistics.median(gaps):+.5f} m", flush=True)
        paired = sum(abs(g) <= PAIRED_ATE for g in gaps)
        print(f"{name}: {paired} of {len(gaps)} keys paired within {PAIRED_ATE} m", flush=True)
        out[name] = {"port": port, "reference": list(reference), "paired": paired}
    return out


def phase_prng(dev, smi):
    """``prng_draws`` (csrc/threefry.cu) against the committed draws of JAX
    (``tests/data/prng_reference.npz``: edge seeds, splits, draws at the
    paths' shapes, the engine's and the RBPF's split trees, and the SHA-256
    of the normal transform over its 2^23 inputs) and against its plain
    version on the card, bit for bit, on every path's plan at edge keys;
    then timed at the tiny and the RBPF step's plans. Returns the
    ``kernels`` entry without the launch count."""
    import hashlib

    from slam_constructor_tpu_torch.ops import kernels, prng

    fixture = Path(__file__).resolve().parent / "tests" / "data" / "prng_reference.npz"
    with np.load(fixture) as f:
        manifest = json.loads(bytes(f["manifest"]).decode())
        want_sha = bytes(f["transform_sha256"]).decode()
        head = f["transform_head"]
        wants = {k: f[k] for k in f.files if k.startswith("case_")}

    def words(t):
        return t.contiguous().view(torch.int32)

    for c, case in enumerate(manifest):
        root = torch.from_numpy(np.array(case["root"], np.uint32)).to(dev)
        plan = tuple(prng.draw_of(d) for d in case["plan"])
        outs = kernels.prng_draws(root, plan)
        for o, got in enumerate(outs):
            want = torch.from_numpy(np.array(wants[f"case_{c}_{o}"])).to(dev)
            check(tuple(got.shape) == tuple(want.shape) and torch.equal(words(got), words(want)),
                  f"prng_draws differs from JAX's draws: {case['name']}, output {o}")
        if case["name"].startswith("PRNGKey("):
            seed = int(case["name"][8:-1])
            check(torch.equal(words(prng.key(seed, dev)), words(root)),
                  f"prng.key({seed}) is not PRNGKey({seed})")
    table = (prng.Draw((), "transform", (1 << 23,)),)
    k0 = prng.key(0, dev)
    got = kernels.prng_draws(k0, table)[0]
    sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    check(sha == want_sha, f"the normal transform's 2^23 outputs hash {sha}, JAX's {want_sha}")
    check(np.array_equal(got[:4096].cpu().numpy().view(np.uint32), head.view(np.uint32)),
          "the normal transform's first outputs differ from JAX's")
    plain = prng.draws_ref(k0, table)[0]
    check(torch.equal(words(got), words(plain)),
          "the normal transform: kernel and plain version differ on the card")
    print(f"prng_draws vs JAX (committed fixture): {len(manifest)} cases bit for bit; the "
          f"normal transform over its 2^23 inputs hashes {sha[:16]}..., JAX's; the plain "
          f"version on the card the same bits", flush=True)

    edge_keys = {"PRNGKey(0)": prng.key(0, dev), "PRNGKey(-1)": prng.key(-1, dev),
                 "PRNGKey(2^32+7)": prng.key(2**32 + 7, dev),
                 "[2^32-1, 2^32-1]": torch.tensor([-1, -1], dtype=torch.int32,
                                                  device=dev).view(torch.uint32),
                 "30 keys (a particle each)": prng.split(prng.key(5, dev), 30)}
    plans = prng_plans(dev)
    n_out = 0
    for pname, plan in plans.items():
        for kname, key in edge_keys.items():
            got = kernels.prng_draws(key, plan)
            want = prng.draws_ref(key, plan)
            for g, w in zip(got, want):
                check(tuple(g.shape) == tuple(w.shape) and torch.equal(words(g), words(w)),
                      f"prng_draws vs plain differs: {pname} at {kname}")
                check(g.dtype != torch.float32 or bool(torch.isfinite(g).all()),
                      f"prng_draws: non-finite draws ({pname} at {kname})")
                n_out += 1
    print(f"prng_draws vs plain on the card: {len(plans)} paths' plans x {len(edge_keys)} "
          f"keys, {n_out} outputs bit for bit", flush=True)

    entry = {"name": "prng_draws", "route": "cuda",
             "source": "slam_constructor_tpu_torch/csrc/threefry.cu",
             "replaces": "slam_constructor_tpu/ops/matchers.py:75",
             "max_abs_err": 0.0, "library_ms": None, "by_plan": {}}
    key = prng.key(42, dev)
    for pname in ("tiny", "gmapping", "gmapping improved", "synthetic sequence (CLI)"):
        plan = plans[pname]
        ms, plain_ms, chained = time_pair(lambda: kernels.prng_draws(key, plan),
                                          lambda: prng.draws_ref(key, plan), plain_calls=20)
        dev_ms = graph_ms(lambda: kernels.prng_draws(key, plan))
        b_ms, by, (n_bytes, ops, flops) = prng_bound_ms(key, plan)
        print(f"prng_draws [{pname}]: device {dev_ms * 1e3:.2f} us (graph replay), a call "
              f"{ms:.4f} ms, chained {chained:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{b_ms:.7f} ms by {by} ({n_bytes} B, {ops} int32 ops, {flops} f32 ops); "
              f"no PyTorch call draws threefry ({smi})", flush=True)
        entry["by_plan"][pname] = {"device_ms": dev_ms, "ms": ms, "chained_ms": chained,
                                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by}
        if pname == "tiny":
            entry.update(ms=ms, plain_ms=plain_ms, chained_ms=chained, device_ms=dev_ms,
                         bound_ms=b_ms, bound_by=by)
    # for scale: torch.randn of the tiny step's normals (other bits: not the
    # function), the generator the parent's step drew from, a call and chained
    randn = lambda: torch.randn((12, 64, 3), device=dev)  # noqa: E731
    r_call, _, r_chained = time_pair(randn, randn)
    print(f"prng_draws: torch.randn of 12 x 64 x 3 normals {r_call:.4f} ms a call, chained "
          f"{r_chained:.4f} ms (other numbers than the reference's; for scale only)", flush=True)
    entry["torch_randn_ms"], entry["torch_randn_chained_ms"] = r_call, r_chained
    return entry


#: the card's float64 rate outside the tensor cores (NVIDIA's H100 SXM data
#: sheet, dense): the libm functions' double-precision polynomials run there
PEAK_F64_FLOP_PER_S = 34e12
#: float64 and float32 operations of one element of a libm function, counted
#: from csrc/libm.cuh on its longest path (the large reduction's integer
#: product counted as 3 float64 operations): sin, cos and wrap_angle's
#: sincos take a reduction (2), the sine polynomial (7) and the cosine (8)
LIBM_OPS = {"sin": (11, 2), "cos": (12, 2), "sincos": (19, 3), "atan": (0, 26),
            "atan2": (1, 36), "wrap_angle": (19, 40), "exp": (1, 22), "log": (0, 26),
            "sqrt": (0, 2), "pose/compose": (38, 46), "endpoint_angles": (38, 44)}


def libm_bound_ms(op: str, n: int, n_bytes: int):
    """The least time of ``n`` elements of libm function ``op``: the larger
    of its bytes over the memory rate and its float64 and float32
    operations over their rates."""
    f64, f32 = LIBM_OPS[op]
    t = max(n_bytes / PEAK_BYTES_PER_S, n * f64 / PEAK_F64_FLOP_PER_S + n * f32 / PEAK_F32_FLOP_PER_S)
    return t * 1e3, "bytes" if n_bytes / PEAK_BYTES_PER_S >= t else "operations"


def card_unary_digests(fn, dev, n_bufs=6):
    """The 16 block digests of ``fn`` over every float32 word
    (``utils.libm_digest``'s definition): each block of 2^28 words computed
    on the card, its NaNs made canonical there, copied into one of
    ``n_bufs`` pinned host buffers and hashed by a pool of as many threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from slam_constructor_tpu_torch.utils import libm_digest as ld

    bufs = [torch.empty(ld.BLOCK_WORDS, dtype=torch.int32, pin_memory=True)
            for _ in range(n_bufs)]
    pending = [None] * n_bufs
    digests = [None] * ld.BLOCKS

    def hash_block(b, buf):
        digests[b] = hashlib.sha256(memoryview(buf.numpy())).hexdigest()

    with ThreadPoolExecutor(n_bufs) as pool:
        for b in range(ld.BLOCKS):
            i = b % n_bufs
            if pending[i] is not None:
                pending[i].result()
            out = fn(ld.words(b * ld.BLOCK_WORDS, ld.BLOCK_WORDS, dev))
            w = out.view(torch.int32)
            w = torch.where(torch.isnan(out), torch.full_like(w, ld.CANONICAL_NAN), w)
            bufs[i].copy_(w)  # a synchronous copy into pinned memory
            pending[i] = pool.submit(hash_block, b, bufs[i])
        for f in pending:
            if f is not None:
                f.result()
    return digests


def phase_libm(dev, smi):
    """``csrc/libm.cu`` (the reference's sinf, cosf, atanf, atan2f, XLA's
    exp and log, the square root): each function's kernel over all 2^32
    float32 inputs hashed as ``utils/libm_digest.py`` says, against the
    committed digests of the jitted reference (``tests/data/
    libm_digests.json``; the plain versions equal them on the CPU:
    ``scripts/torch_port/libm_exhaustive.py --check``), ``atan2`` over the
    seeded pairs and the grid; the kernels against the plain versions
    (``libm.plain_versions()``) on the card, bit for bit, on 2^24 inputs a
    function and on the fused sites (the pose operations, the scan's
    endpoint angles, the log-sum-exp rows, the fused multiply-add); then
    timed at the paths' shapes beside torch's own function and the bound.
    Returns the ``kernels`` entry without the launch count."""
    from slam_constructor_tpu_torch.ops import geometry, kernels, libm
    from slam_constructor_tpu_torch.utils import libm_digest as ld

    want = ld.load()
    t0 = time.perf_counter()
    for op in ld.UNARY:
        t = time.perf_counter()
        blocks = card_unary_digests(lambda x, op=op: kernels.libm_unary(op, x), dev)
        got = ld.combine(blocks)
        bad = [b for b, (g, w) in enumerate(zip(blocks, want["unary"][op]["blocks"])) if g != w]
        print(f"libm {op}: the kernel over all 2^32 inputs hashes {got[:16]}..., the jitted "
              f"reference {want['unary'][op]['digest'][:16]}...: "
              f"{'equal' if not bad else f'blocks {bad} differ'} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
        check(not bad, f"libm {op}: the kernel's digest differs from the reference's")
    got = ld.atan2_digest(kernels.libm_atan2, dev, 1 << 22, 8)
    check(got == want["atan2"], "libm atan2: the kernel's digest differs from the reference's")
    print(f"libm atan2 over {ld.BLOCKS} x 2^22 seeded pairs and the {ld.atan2_grid().size}^2 "
          f"grid: equal to the reference's digest; the digests took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    g = torch.Generator(device=dev).manual_seed(11)
    words = torch.randint(-2**31, 2**31, (1 << 24,), generator=g, dtype=torch.int64, device=dev)
    x = words.to(torch.int32).view(torch.float32)
    y = x.roll(12345)
    finite = torch.where(torch.isfinite(x), x, 0.5) * 1e-30  # fma operands of every size
    poses = torch.rand((1 << 20, 3), generator=g, device=dev) * torch.tensor(
        [40.0, 40.0, 8.0], device=dev) - torch.tensor([20.0, 20.0, 4.0], device=dev)
    other = poses.roll(1, 0)
    bearings = torch.linspace(-math.pi, math.pi, 360, device=dev)
    logw = torch.randn((4096, 30), generator=g, device=dev) * 20
    logw[0, 3] = -math.inf
    cases = [(op, lambda op=op: libm._unary(op, x)) for op in ld.UNARY]
    cases += [("sincos", lambda: torch.stack(libm.sincos(x))), ("cossin", lambda: libm.cossin(x)),
              ("atan2", lambda: libm.atan2(y, x)),
              ("fma32", lambda: libm.fma32(x, y, finite)),
              ("fma32 (numbers)", lambda: libm.fma32(x, 1.7, -0.25)),
              ("pose/compose", lambda: geometry.compose(poses, other)),
              ("pose/between", lambda: geometry.between(poses, other)),
              ("pose/inverse", lambda: geometry.inverse(poses)),
              ("rows/lse", lambda: libm.logsumexp(logw)),
              ("rows/normalize", lambda: libm.normalize_log(logw)),
              ("rows/softmax", lambda: torch.cat([libm.softmax_lse(logw)[0],
                                                  libm.softmax_lse(logw)[1][:, None]], 1)),
              ("rows/ess", lambda: libm.effective_sample_size(logw))]
    for name, fn in cases:
        got = fn()
        with libm.plain_versions():
            plain = fn()
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(plain)) or torch.equal(
            bits(torch.where(torch.isnan(got), math.nan, got)),
            bits(torch.where(torch.isnan(plain), math.nan, plain)))
        check(same, f"libm {name}: the kernel differs from its plain version on the card")
    print(f"libm: {len(cases)} functions and fused sites bit for bit with their plain versions "
          f"on the card (2^24 inputs a function; 2^20 poses; 4,096 rows of 30)",
          flush=True)

    # timed: a sine of the scan's 360 bearings against torch.sin (other bits:
    # the yardstick), and the paths' own sites
    entry = {"name": "libm", "route": "cuda", "source": "slam_constructor_tpu_torch/csrc/libm.cu",
             "replaces": "slam_constructor_tpu/ops/geometry.py:26", "max_abs_err": 0.0,
             "by_site": {}}
    b360 = bearings.contiguous()
    pose1, delta1 = poses[:1].contiguous(), other[:1].contiguous()
    for site, n, n_bytes, kernel, library in (
            ("sin", 360, 8 * 360, lambda: kernels.libm_unary("sin", b360),
             lambda: torch.sin(b360)),
            ("pose/compose", 1, 36, lambda: kernels.libm_pose("compose", pose1, delta1), None)):
        with libm.plain_versions():
            plain = {"sin": lambda: libm._sin_ref(b360),
                     "pose/compose": lambda: geometry.compose(pose1, delta1)}[site]
            ms, plain_ms, chained = time_pair(kernel, plain, plain_calls=20)
        dev_ms = graph_ms(kernel)
        lib_ms = graph_ms(library) if library else None
        lib_call = time_pair(library, library)[0] if library else None
        b_ms, by = libm_bound_ms(site, n, n_bytes)
        print(f"libm {site} ({n} elements): device {dev_ms * 1e3:.2f} us (graph replay), a call "
              f"{ms:.4f} ms, chained {chained:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{b_ms:.7f} ms by {by}"
              + (f"; torch.{site} {lib_ms * 1e3:.2f} us device, {lib_call:.4f} ms a call "
                 f"(other bits)" if library else "") + f" ({smi})", flush=True)
        entry["by_site"][site] = {"device_ms": dev_ms, "ms": ms, "chained_ms": chained,
                                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                                  "library_ms": lib_ms}
    # the entry's numbers: a site of every main path, the prior's compose;
    # no one PyTorch call computes it (torch.sin's time stands beside the
    # sine's site in by_site)
    c = entry["by_site"]["pose/compose"]
    entry.update(ms=c["ms"], plain_ms=c["plain_ms"], chained_ms=c["chained_ms"],
                 device_ms=c["device_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                 library_ms=None)
    return entry


def phase_mc_match_keyed(dev, tiny_states, viny_states, full_states):
    """``mc_match`` drawing its own numbers from the engine step's key
    (``kernels.KeyNoise``: split, then a split a round and erf_inv of
    jax.random.normal's uniform, in the kernel's prologue) against the same
    match handed those draws (``kernels.ErfInvDraws``, drawn by
    ``prng``'s plain version on the card), bit for bit, and the next key
    against ``split(key)[0]``, on the recorded states of the three main
    paths (the 16 of the full path among them) and at edge keys, rounds and
    batches; then its device time beside the handed-in route's."""
    from slam_constructor_tpu_torch.ops import kernels, prng

    def keyed(args, kn):
        a = list(args)
        a[5] = kn
        return tuple(a)

    def handed(args, kn):
        a = list(args)
        a[5] = kernels.ErfInvDraws(kn.draws()[1])
        return tuple(a)

    cases = []
    for path, states in (("tiny", tiny_states), ("viny", viny_states), ("full", full_states)):
        for i, a in enumerate(states):
            kn = KEYED_DRAWS.get(id(a[5]))
            check(kn is not None and kn.step, f"{path} state {i}: the match did not draw from "
                  "the step's key")
            cases.append((f"{path} state {i}", a, kn))
    t = tiny_states[3]
    for kname, words in (("PRNGKey(0)", [0, 0]), ("[2^32-1, 2^32-1]", [-1, -1]),
                         ("PRNGKey(2^31)", [0, -2**31])):
        key = torch.tensor(words, dtype=torch.int32, device=dev).view(torch.uint32)
        for rounds, batch in ((12, 64), (0, 64), (1, 8), (16, 100), (3, 1)):
            cases.append((f"{kname}, {rounds} rounds of {batch}", t,
                          kernels.KeyNoise(key, rounds, batch, step=True)))
        cases.append((f"{kname}, no split (the match's own key)", t,
                      kernels.KeyNoise(key, 12, 64, step=False)))
    for name, a, kn in cases:
        got = kernels.mc_match(*keyed(a, kn))
        ref = kernels.mc_match(*handed(a, kn))
        check(all(torch.equal(bits(g), bits(r)) for g, r in zip(got[:3], ref)),
              f"mc_match with in-kernel draws differs from the handed-in draws ({name})")
        if kn.step:
            want_key = kn.draws()[0]
            check(len(got) == 4 and torch.equal(got[3].view(torch.int32),
                                                want_key.view(torch.int32)),
                  f"mc_match's next key is not split(key)[0] ({name})")
    print(f"mc_match with in-kernel draws: {len(cases)} cases bit for bit with the match handed "
          f"the same draws (prng's plain version on the card), the next key split(key)[0]",
          flush=True)
    a = tiny_states[3]
    kn = KEYED_DRAWS[id(a[5])]
    out = {}
    for route, args in (("in-kernel draws", keyed(a, kn)), ("handed-in draws", handed(a, kn))):
        out[route] = graph_ms(lambda args=args: kernels.mc_match(*args))
    print(f"mc_match tiny state, device time (graph replay): in-kernel draws "
          f"{out['in-kernel draws'] * 1e3:.2f} us, handed-in draws "
          f"{out['handed-in draws'] * 1e3:.2f} us", flush=True)
    return {"keyed_cases_bitwise": len(cases),
            "keyed_device_ms": out["in-kernel draws"],
            "handed_device_ms": out["handed-in draws"]}


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    from slam_constructor_tpu_torch.models import tiny, viny
    from slam_constructor_tpu_torch.ops import _build
    from slam_constructor_tpu_torch.utils import evaluate

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)  # name, power limit

    res = _build.build()
    print(f"build: {res.path.name} in {res.seconds:.2f} s (nvcc, sm_90a)", flush=True)
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    _build.load()
    if sys.argv[1:] == ["--phase", "prng"]:
        # the PRNG kernel alone (its fixture, its plain version, its times); no result
        phase_prng(dev, smi)
        print("phase prng passed", flush=True)
        return
    if sys.argv[1:] == ["--phase", "libm"]:
        # the reference's math library alone (digests, plain versions, times); no result
        phase_libm(dev, smi)
        print("phase libm passed", flush=True)
        return

    scans, odom, gt = bench_sequence(dev)
    k1 = phase_overlap_kernel(dev, scans, gt)
    k2 = phase_polar_kernel(dev, scans, gt)
    k_prng = phase_prng(dev, smi)
    k_libm = phase_libm(dev, smi)

    tiny_cfg, viny_cfg = tiny.tiny_config(map_size=MAP), viny.viny_config(map_size=MAP)
    gm_cfg = gmapping_config()
    k_bw = phase_beam_weights(dev, scans, smi)
    gm_states = capture_particle_matches(gm_cfg, scans, odom, gt)
    k5 = phase_particle_match(dev, gm_states)
    k5.update(phase_particle_keys(dev, gm_states))
    fscans, fodom, fgt = full_sequence(dev)
    full_cfg = full_config()
    full_states, kept = capture_full_launches(full_cfg, fscans, fodom, fgt)
    tiny_states = capture_match_states(tiny_cfg, scans, odom, gt)
    viny_states = capture_match_states(viny_cfg, scans, odom, gt)
    k3 = phase_mc_match(dev, tiny_states, viny_states, full_states)
    k3.update(phase_mc_match_keyed(dev, tiny_states, viny_states, full_states))
    k3.update(phase_mc_match_scan(dev, {
        "tiny": capture_scan_matches(tiny_cfg, scans, odom, gt),
        "viny": capture_scan_matches(viny_cfg, scans, odom, gt)}))
    k1["score_sites"] = phase_score_sites(dev, scans, gt)
    phase_card_vs_cpu("tiny", tiny_cfg, dev, scans, odom, gt)
    phase_card_vs_cpu("viny", viny_cfg, dev, scans, odom, gt)

    odo_ate = float(evaluate.ate(odometry_trajectory(gt[0], odom), gt, align=False))
    tiny_launches, tiny_traj, _ = phase_main_path(
        "tiny", tiny_cfg, expect(mc_match=N_SCANS, scan_insert=N_SCANS), scans,
        odom, gt, odo_ate, 0.15, expect_libm("tiny"))
    viny_launches, viny_traj, _ = phase_main_path(
        "viny", viny_cfg, expect(mc_match=N_SCANS, polar_free_plane=N_SCANS, scan_insert=N_SCANS,
                                 beam_weights=N_SCANS),
        scans, odom, gt, odo_ate, max(VINY_REFERENCE_ATE_BY_KEY) + VINY_ATE_MARGIN,
        expect_libm("viny"))
    rounds_launches = phase_rounds_path(viny_cfg, scans, odom, gt, viny_traj)
    # every path once more with K3's plain twin handed in, keeping insert calls
    kept_inserts, twin_runs = {}, {}
    for name, cfg_, traj_ in (("tiny", tiny_cfg, tiny_traj), ("viny", viny_cfg, viny_traj)):
        kept_inserts[name], twin_runs[name] = held_to_twin_insert(
            name, lambda c=cfg_: run_main_path(c, scans, odom, gt, 0)[0], traj_)

    full_odo_ate = float(evaluate.ate(odometry_trajectory(fgt[0], fodom), fgt, align=False))
    full_launches = phase_full_path(full_cfg, fscans, fodom, fgt, full_odo_ate)
    kept_planes, planes_runs = {}, {}
    kept_planes["full"], planes_runs["full"] = held_to_twin_planes(
        "full", lambda: run_full_path(full_cfg, fscans, fodom, fgt, 0)[1])
    kept_inserts["full"], twin_runs["full"] = held_to_twin_insert(
        "full", lambda: run_full_path(full_cfg, fscans, fodom, fgt, 0)[1])
    k4 = phase_batched_kernel(dev, kept)
    phase_full_card_vs_cpu(dev)

    gm_launches = phase_gmapping_path(gm_cfg, scans, odom, gt, odo_ate, smi)
    phase_ate_by_key((
        ("tiny", lambda k: run_main_path(tiny_cfg, scans, odom, gt, 0, seed=k)[0], gt,
         TINY_REFERENCE_ATE_BY_KEY),
        ("viny", lambda k: run_main_path(viny_cfg, scans, odom, gt, 0, seed=k)[0], gt,
         VINY_REFERENCE_ATE_BY_KEY),
        ("full (corrected)", lambda k: run_full_path(full_cfg, fscans, fodom, fgt, 0, seed=k)[1],
         fgt, FULL_REFERENCE_ATE_BY_KEY),
        ("gmapping (winner)", lambda k: run_gmapping_path(
            gm_cfg, scans, odom, gt, 0, seed=k)[0].winner_trajectory(), gt,
         GMAPPING_REFERENCE_ATE_BY_KEY)))
    kept_inserts["gmapping"], twin_runs["gmapping"] = held_to_twin_insert(
        "gmapping", lambda: run_gmapping_path(gm_cfg, scans, odom, gt, 0)[1])
    phase_gmapping_quality(gm_cfg, dev)
    improved_launches, k4["rbpf_m30_k16_and_k1"] = phase_gmapping_improved(dev, scans, odom, gt)
    phase_gmapping_card_vs_cpu(dev, scans, odom, gt)

    m3_cfg = viny.viny_m3rsm_config(map_size=MAP)
    path_searches, m3_warm = capture_m3rsm_searches(m3_cfg, scans, odom, gt)
    m3_launches, m3_traj, m3_engine = phase_m3rsm_path(m3_cfg, scans, odom, gt, odo_ate)
    kept_inserts["viny_m3rsm"], twin_runs["viny_m3rsm"] = held_to_twin_insert(
        "viny_m3rsm", lambda: run_main_path(m3_cfg, scans, odom, gt, 0)[0], m3_traj)
    phase_card_vs_cpu("viny_m3rsm", m3_cfg, dev, scans, odom, gt, n=32)
    levels_launches = phase_m3rsm_levels_path(m3_cfg, scans, odom, gt, m3_traj)
    phase_m3rsm_match_many(m3_cfg, m3_engine, scans, gt)
    full_m3_cfg = full_m3rsm_config()
    builds, loop_searches = capture_full_m3rsm(full_m3_cfg, fscans, fodom, fgt)
    k8 = phase_m3rsm_search_kernel(dev, m3rsm_search_cases(
        dev, path_searches, loop_searches, m3_cfg, m3_engine, scans, gt))
    k7 = phase_m3rsm_level_kernel(dev, level_launches_of(path_searches))
    k6 = phase_m3rsm_pyramid_kernel(dev, m3_warm.state.gm, m3_cfg.cell_model, builds)
    full_m3_launches = phase_full_path(full_m3_cfg, fscans, fodom, fgt, full_odo_ate,
                                       name="full_m3rsm", reference=FULL_M3RSM_REFERENCE_ATE_BY_KEY,
                                       hold_to_tracker=False)
    kept_planes["full_m3rsm"], planes_runs["full_m3rsm"] = held_to_twin_planes(
        "full_m3rsm", lambda: run_full_path(full_m3_cfg, fscans, fodom, fgt, 0)[1])
    cli_launches, grad_kept, score_kept, refine_kept, rates, cli_inserts = phase_cli(dev)
    phase_overlap_csail(dev, k1, score_kept)
    k9 = phase_overlap_grad_kernel(dev, grad_kept, smi)
    k10 = phase_refine_kernel(dev, "gradient_refine", refine_kept["gradient_refine"], rates, smi)
    k11 = phase_refine_kernel(dev, "hill_climb", refine_kept["hill_climb"], rates, smi)

    k_red = phase_reducer_kernels(dev, capture_baseline_matches(scans, odom, gt), smi)
    base_launches, base_by_reducer = phase_gmapping_baseline_path(scans, odom, gt, odo_ate, smi)
    kept_inserts["gmapping preset"], twin_runs["gmapping preset"] = held_to_twin_insert(
        "gmapping preset",
        lambda: run_gmapping_path(None, scans, odom, gt, 0, make=baseline_engine)[1])
    phase_gmapping_card_vs_cpu(dev, scans, odom, gt, n=8, make=baseline_engine,
                               name="gmapping preset")
    phase_relocalize(dev)
    pool_kept, pool_runs, prep_kept = {}, {}, {}
    for name, (calls, found, *prep) in cli_inserts.items():
        if name == "mit_stata":
            pool_kept[f"cli {name}"], pool_runs[f"cli {name}"] = calls, found
            prep_kept[f"cli {name}"] = prep[0]
            continue
        twin_runs[f"cli {name}"] = found
        if name in ("mit_csail", "tum_2d"):
            kept_inserts[name] = calls
    cow_launches, pool_kept["gmapping cow"], pool_runs["gmapping cow"], \
        prep_kept["gmapping cow"], cow_summary = phase_gmapping_cow_path(scans, odom, gt, odo_ate,
                                                                         smi)
    phase_gmapping_cow_quality(dev, smi)
    phase_gmapping_cow_card_vs_cpu(dev, scans, odom, gt, smi)
    grow_summary = phase_auto_grow(dev, scans, odom, gt, smi)
    k12 = phase_scan_insert_kernel(dev, kept_inserts, smi)
    k12["twin_insert_runs"] = twin_runs
    k13 = phase_scan_planes_kernel(dev, kept_planes, fscans, fgt, smi)
    k13["twin_planes_runs"] = planes_runs
    k14, k15, k16 = phase_pool_kernels(pool_kept, prep_kept, smi)
    k14["twin_pool_runs"] = pool_runs
    k14["gmapping_cow"], k14["auto_grow"] = cow_summary, grow_summary

    # slice 6d: every matcher in every slot, the gradient at every reducer,
    # the checkpoints
    slot_paths, slot_kept, slot_summary = phase_gmapping_slots(scans, odom, gt, odo_ate, smi)
    phase_gmapping_slots_card_vs_cpu(dev, scans, odom, gt)
    loop_kept = {}
    for loop_kind, reference in (("hill_climbing", FULL_HILL_REFERENCE_ATE_BY_KEY),
                                 ("gradient", FULL_GRADIENT_REFERENCE_ATE_BY_KEY)):
        loop_cfg = full_loop_config(loop_kind)
        path = f"full {loop_kind}"
        loop_kept[path] = capture_loop_refines(loop_cfg, fscans, fodom, fgt)
        slot_paths[path] = phase_full_path(loop_cfg, fscans, fodom, fgt, full_odo_ate, name=path,
                                           reference=reference, hold_to_tracker=False)
    joint_launches, joint_kept = phase_joint_refine_slots(dev, fscans, fgt)
    slot_paths.update({f"joint_refine {m}": v for m, v in joint_launches.items()})
    cli_refine_launches, cli_refine_kept = phase_cli_refine_reducers(dev)
    slot_paths.update(cli_refine_launches)
    phase_checkpoint(dev, scans, odom, gt, fscans, fodom, fgt)
    k_slots = phase_slot_kernels(slot_kept, loop_kept, joint_kept, cli_refine_kept, slot_paths,
                                 smi)
    k_slots[0]["gmapping_slots"] = slot_summary

    # slice 7: the multi-device layer in an NCCL group of one (torn down
    # before the next phase), then the partial score's kernel mode
    par_launches = phase_parallel(dev, scans, odom, gt, fscans, fodom, fgt, smi)
    k_part = phase_partial_kernel(dev, scans, gt, smi)

    # `launches`: of a main path's timed run, held to the expected counts
    # above: the viny path's for the kernels of the earlier slices, the full
    # path's for the batched score, the gmapping path's for the particle
    # match, the viny_m3rsm path's for the M3RSM kernels, the CLI's
    # mit_csail run for `hill_climb` and `overlap_score` and its tiny_refined
    # run for `gradient_refine` and `overlap_score_grad`, the full path's for
    # `scan_planes`, the copy-on-write RBPF's for the pool kernels. `m3rsm_level`,
    # `overlap_score` and `overlap_score_grad` left the main paths, so they
    # read 0 there; the paths driven with their yardsticks handed in stand
    # under `launches_by_path` only
    main_path = {"overlap_score_batched": full_launches, "mc_match_batched": gm_launches,
                 "overlap_score": cli_launches["mit_csail"], "m3rsm_pyramid": m3_launches,
                 "m3rsm_level": m3_launches, "m3rsm_search": m3_launches,
                 "overlap_score_grad": cli_launches["tiny_refined"],
                 "gradient_refine": cli_launches["tiny_refined"],
                 "hill_climb": cli_launches["mit_csail"], "scan_insert": tiny_launches,
                 "scan_planes": full_launches, "pool_insert": cow_launches,
                 "pool_prepare": cow_launches, "pool_touched": cow_launches,
                 "prng_draws": gm_launches}
    for k in (k1, k3, k2, k4, k5, k6, k7, k8, k9, k10, k11, k12, k13, k14, k15, k16, k_prng,
              k_bw):
        k["launches"] = main_path.get(k["name"], viny_launches)[k["name"]]
        k["launches_by_path"] = {
            "tiny": tiny_launches[k["name"]], "viny": viny_launches[k["name"]],
            "full": full_launches[k["name"]], "gmapping": gm_launches[k["name"]],
            "gmapping preset": base_launches[k["name"]],
            "viny_m3rsm": m3_launches[k["name"]], "full_m3rsm": full_m3_launches[k["name"]],
            f"viny, one overlap_score launch a round, {ROUNDS_PATH_SCANS} scans":
                rounds_launches[k["name"]],
            f"gmapping, improved proposal, {GM_IMPROVED_SCANS} scans": improved_launches[k["name"]],
            "viny_m3rsm, a level launch a level and a score launch a round":
                levels_launches[k["name"]],
            "gmapping cow": cow_launches[k["name"]],
            **{f"cli {name}": counts[k["name"]] for name, counts in cli_launches.items()},
            **{name: counts[k["name"]] for name, counts in slot_paths.items()},
            **{f"{name} (NCCL, world 1)": counts[k["name"]]
               for name, counts in par_launches.items()}}
    # the reducer variants of the particle match: launches of the gmapping
    # preset's timed run, by reducer (the path scores with the obstacle one)
    for k in k_red:
        k["launches"] = base_by_reducer[k["name"].split(" ")[0]]
        k["launches_by_path"] = {"gmapping preset": k["launches"]}
    # the partial score: launches of the row-sharded block map's run
    k_part["launches"] = par_launches["blockshard"]["overlap_score_partial"]
    k_part["launches_by_path"] = {f"{name} (NCCL, world 1)": counts["overlap_score_partial"]
                                  for name, counts in par_launches.items()}
    # libm: launches of the gmapping path's timed run (the proposal, the
    # scan's points, the weights and the resampling a step, held by
    # check_libm; tiny and viny launch none), counted apart by function
    check(not LIBM_PARTED, f"libm launches parted on {len(LIBM_PARTED)} paths: {LIBM_PARTED}")
    k_libm["launches"] = LIBM_BY_PATH["gmapping"]["total"]
    k_libm["launches_by_path"] = {name: counts for name, counts in LIBM_BY_PATH.items()}
    print(json.dumps({"kernels": [k1, k3, k2, k4, k5, k6, k7, k8, k9, k10, k11, k12, k13,
                                  k14, k15, k16, *k_red, *k_slots, k_part, k_prng, k_libm,
                                  k_bw]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
