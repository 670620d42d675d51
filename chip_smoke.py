"""Drive the PyTorch/H100 port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Nine paths run, each through the entry points a user calls.

Odometry: the headline workload of ``bench.py``, ported: a VLP-16-like sweep
pair (16 rings x 1024 columns) ray-cast in ``make_room_world(seed=42)``,
feature extraction, clouds compacted to a multiple of 256 points, and
``batch_odometry_solve`` of B = 512 independent problems against one shared
reference pair, each lane from its own initial guess ``0.02 * randn(6)``,
with the default ``OdometryConfig``.

Scan-to-map: the problem of ``benchmarks/bench_scan_match.py``, ported: a
surround map aggregated from 6 sweeps around the start pose in
``make_room_world(seed=7)`` and voxel-filtered (0.2 / 0.4 m), the frame of
the next sweep through ``prepare_frame``, all compacted to 256-point
granules, and ``batch_scan_match`` of B = 64 frames against the one shared
map (10 GN iterations, 5-NN line and plane fits, the score gate), default
``ScanMatchConfig``, priors ``0.02 * randn(6)``.  Everything runs on the card.

Single stream: the drive of ``benchmarks/bench_realtime.py``, ported: 14
VLP-16 sweeps (16 x 1024) of a straight drive, 0.35 m per sweep, in a
30 x 4 x 60 m room with 10 pillars (seed 9), through ``models/fused``
(``init_sweep``, then ``odometry_sweep`` / ``mapping_sweep`` on every second
sweep) at the default ``PipelineConfig``: the default capacities and the
default 21 x 11 x 21 cube map on the card.

Pipeline: the system's own entry point, ``models/pipeline.SlamPipeline``, over
the single-stream sweeps in its three modes ("mapping" with IMU / UKF fusion
and the in-loop cube-map dedup, "local", "localization"), then README.md's
Quick start (a 49-sweep figure eight) on the card.

Pose graph: the LM solve of ``ops/pose_graph`` on the 1024-node
loop-closure graph of ``benchmarks/bench_pose_graph.py`` (dense Cholesky and
block-Jacobi CG, the default ``PoseGraphConfig``) and CG at 4096 nodes; then
``SlamPipeline(enable_graph=True)`` over the loop drive of
tests/test_graph_pipeline.py at full width (52 noisy VLP-16 sweeps of a
5 m circle): keyframes, loop candidates, ICP on the nn1 kernel, the damped
fine match on the k-NN kernel, loop edges and the LM; then
``GraphSlam.save`` and the saved map reloaded.

Parity modes: the reference's iteration dynamics (the port-typo Jacobian,
the -0.05 under-relaxation, the LU solve, the row-zeroing projector) through
``batch_odometry_solve``, ``models/laser_odometry.step`` and
``batch_scan_match`` with ``parity_mode=True``, held to the float64 C++
transcription ``tests/ref_oracle.py``; then ``dewarp_passes=2`` through
``SlamPipeline`` and ``extract_features_debug``.

Out-of-core map and host I/O: ``SlamPipeline`` with ``matcher.dynamic_mode``
over tests/test_long_run.py's corridor at full width (cubes paged to disk by
the native pager, built from ``native/cube_pager.cpp``), the offline map
converter (``io/feature_extracter``, the k-NN kernel at k = 10 over a whole
map cloud) and localization on its output, and the ``run_offline.py --bag``
flow (``io/rosbag``, ``organize_unordered`` and the native binner, then the
pipeline), with one sweep traced by ``utils/profiling.trace``.

The parallel layer on ``torch.distributed``: the sharded odometry and
scan-to-map solves (``parallel/batch``), the edge-sharded pose-graph LM,
``SlamPipeline(map_mesh=...)`` on the striped cube map
(``maps/sharded_map``), first on a mesh of one rank under NCCL, then on two
ranks in spawned processes (NCCL on two cards, or gloo with both ranks on
the one card); and the capacity-bucketed odometry solve of a heterogeneous
batch.

The entry scripts (``cooper_mapper_torch/examples``): the offline runner
``run_offline.run`` over sweep files at the HDL-64E and HDL-32 presets at
full width (64 x 2048 and 32 x 2048 points per sweep), ``python -m
cooper_mapper_torch.examples.run_offline --selftest`` as a user runs it,
and the four demos at their defaults.

Phases, each announced on its own line as it starts:

1. the card's name and power limit;
2. the kernels' build (one nvcc process per source, started together, then
   one link), with its seconds and ptxas report;
3. every race kernel against its plain PyTorch version at the odometry
   path's shapes: indices equal for every query inside the 25 m^2 gate (a
   true tie, distances within 1e-5 relative, is counted and must stay under
   0.1% of queries), distances within 1e-4 relative; kernel, plain and
   library times (nn1 at both its shapes, surf and corner);
4. the odometry path once with every launch counter at 0, then: all lanes
   finite, four lanes equal to a CPU run of the same solve (plain versions)
   within 2e-3, every race kernel launched; then the steady-state solves/s;
5. ground truth: the same solve with ``cv_dewarp=False`` (the s-scaled warp
   model, the configuration of ``tests/test_odometry.py::test_recovers_motion``)
   must put every lane within 0.05 m / 0.01 rad of the simulator's motion.
   The default path's own errors are printed beside it;
6. the scan-to-map problem, then the k-NN kernel against ``knn_plain`` at
   that path's two shapes (surf and corner, shared map), with a per-problem
   reference, a ragged shape and duplicate points across tiles: indices and
   distances bit-identical; kernel, plain and library times;
7. the scan-to-map path once with every launch counter at 0, then: 22 k-NN
   launches (2 per residual build, 11 builds), every lane finite and
   ``success``, four lanes equal to a CPU run within 2e-3; score, match
   fraction and iterations; steady-state solves/s; ``scan_match_local`` on
   lane 0 against the CPU;
8. the fused race kernel against its plain version, bit for bit, at the
   single-stream shapes (B = 1: 256 vs 2048 corner, 1024 vs 8192 surf, from
   the drive's first two sweeps) and the odometry bench shapes (B = 512),
   with a per-problem reference and a ragged M; and against the split
   kernels (nn1 -> bc_races / nn1_masked "adj") on every query whose race-A
   winner is valid; the split kernels against their plain versions, bit for
   bit on every query, at the B = 1 shapes; kernel, plain and library times
   beside the bound, for the fused kernel and, where they split M across
   blocks, for the split kernels at the B = 1 shapes: bc_races and nn1 at
   1 x 1024 vs 8192, nn1 and nn1_masked "adj" at 1 x 256 vs 2048; at each
   of the four fused shapes the fused kernel's device ms (profiler) beside
   the split route's (nn1, then bc_races or nn1_masked "adj", their merges
   and the ring gather); then merge_min against its plain version, bit for
   bit, on the chunks' results of the split races at the B = 1 shapes (S = 66
   of 1024 queries, S = 32 of 256, and S = 32 of 1024), with its times;
9. the single-stream drive on the split route (the default), with
   ``COOPER_PALLAS_FUSED=1``, and on the split route again, every launch
   counter at 0 before each: per odometry sweep 10 + 5 + 5 split race
   launches and no fused one, or 10 fused and no split one, and of the
   split ones the merges that ``_split_plan`` implies at B = 1 (as many
   merge_min launches; none on the fused route); 22 k-NN
   launches per mapping sweep; poses bit-identical on both routes and on
   the repeat; the final position within 0.3 m of the simulator's
   (tests/test_pipeline.py::TestFusedSteps' bound); a non-empty map; ms per
   odometry and mapping sweep (best and median of sweeps 3..13) against
   LOAM's 100 / 1000 ms budgets; the map's bytes on the card;
10. the k-NN kernel against ``knn_plain``, bit for bit, on a mapping sweep's
   own searches: sweep 4's prepared frame (1 x 8192 surf, 1 x 2048 corner)
   registered at the merge guess against the surround (65536 / 32768) of
   the map that sweeps 0..3 built, where the kernel splits M across blocks
   (the plan is printed); kernel, plain and library times beside the bound;
11. localization on phase 9's map over a second drive 0.8 m to the side, seeded
   0.3 m / 0.035 rad off (tests/test_localization.py's perturbation): the
   steady error (mean from the third solve on) below half the seed error,
   and the map's tensors unchanged;
12. the card against the CPU at the reduced configuration of
   tests/test_pipeline.py::TestFusedSteps (16 x 512 sweeps, a 7 x 3 x 7
   map, 6 sweeps): every pose within 2e-3;
13. ``SlamPipeline(mode="mapping")`` over phase 9's sweeps at the default
   ``PipelineConfig`` but for TestImuFusion's ``mapping_stride=1`` and
   ``cool_time_duration=0``, with
   an IMU window per sweep (10 samples of zero acc / gyro, 0.1 s per sweep),
   every launch counter at 0 first: per sweep the split route's race
   launches of phase 9 and 22 k-NN launches where a map solve ran; the final
   merged position within 0.3 m of the simulator's; ``stats()`` adds up;
   dedup ran; ``fused_pose()`` within 0.5 m of the last merged pose
   (TestImuFusion's bound); ``imu_rate_poses`` finite at [10, 4, 4]; the
   StageTimer report and ms per sweep; then ``dedup_active`` on the built
   map, on the card twice and on the CPU: bit-identical;
14. ``SlamPipeline(mode="local")`` over the same sweeps at the default
   config but for ``max_frame_corner=2048`` (the window's corner slots; at
   the default 4096 the window rejects the 2048-point corner frame, in the
   JAX package too): the final position within 0.3 m, the ATE printed;
15. ``SlamPipeline(mode="localization")`` on phase 13's map over phase 11's
   drive, seeded by ``initial_pose`` as phase 11: the steady error below half
   the seed error, the map unchanged;
16. README.md's Quick start in the port (``make_room_world(seed=1)``,
   ``figure_eight_trajectory(50)``, 49 sweeps, ``PipelineConfig()``): every
   pose finite, ``pipeline_ate`` of mapping and odometry printed;
17. the pipeline on the card against the CPU at tests/test_pipeline.py's
   reduced configuration (``_small_cfg``, ``_simulate(6)``) on the same
   sweeps (simulated on the CPU): mapping with dedup after every solve and
   IMU windows, local, and localization on the mapping run's map, every
   merged pose within 2e-3; ``dedup_active`` of the card's map on the card,
   again, and on the CPU: bit-identical; then, printed only, the mapping
   drive on the card's own simulated sweeps against the CPU's;
18. the pose-graph LM on build_graph(1024) of benchmarks/bench_pose_graph.py
   (1023 odometry edges, 10 loop edges, max_edges 2048), ``solver="dense"``
   at the default 50 iterations and ``"cg"`` at 64 CG iterations, then CG on
   build_graph(4096): the final cost finite and below 0.2 of the initial one,
   a repeat bit-identical, node 0 unchanged; ms per optimize and LM
   iterations/s (best and median of 2), the dense-vs-CG position
   difference, the peak memory;
19. the pose-graph LM on build_graph(64, loop_every=16), dense and CG, on
   the card and the CPU: poses within 2e-3 and the same final lambda (where
   the lambdas differ, the LM iteration at which the accept sequences part
   is printed, and the phase fails);
20. ``SlamPipeline(enable_graph=True)`` over the loop drive of
   tests/test_graph_pipeline.py at full width (make_room_world(size=(30, 4,
   40), n_pillars=8, seed=3), a 5 m circle closing after 48 sweeps, 52
   sweeps of 16 x 1024, noise 0.03 m from a torch.Generator) at the default
   config but for _cfg's loop gates (3.0 / 9.0 / 12.0 / 2.0) and its
   score_threshold of 50 (the default 800 is out of reach on this drive:
   each map solve's score and frame size are printed):
   TestGraphInTheLoop's gates (a loop joining keyframes more than 8 apart;
   the graph's keyframe ATE below the mapping poses' and below 0.25 m;
   a graph pose on every result after the first; the corrected trajectory
   applies a correction; the end pose within the merged one's + 0.05 m; the
   graph counters in stats()); the nn1 and k-NN kernels launched inside the
   graph stage; the StageTimer report, the optimize calls' ms, the loop
   fine matches' scores, ms per sweep;
21. at the drive's first loop: ICP on the card against the CPU (T within
   1e-4, inliers equal); nn1 against nn1_plain at the ICP shape (the
   keyframe's 8192 surf slots against a 6-keyframe stack) and the k-NN
   against knn_plain at the fine match's voxel-filtered shape, bit for
   bit, with their plans, times and bounds;
22. ``GraphSlam.save`` into a temporary directory: after.g2o holds the
   estimates within 1e-5 and the edges' information exactly; the saved map,
   loaded by ``load_feature_map`` in "localization" mode, localizes the
   drive's last sweep within 0.3 m;
23. the graph pipeline on the card against the CPU at phase 17's reduced
   configuration (dedup after every map solve) with
   tests/test_torch_graph_pipeline.py's loop gates on the same sweeps (7 of
   ``_simulate``, simulated on the CPU): the same keyframe and loop flags
   and loops, graph estimates and graph poses within 2e-3, with every map
   solve's score and match fraction printed;
24. the parity modes (the reference's iteration dynamics) against the float64
   transcription of the C++ solves, ``tests/ref_oracle.py`` (loaded by path;
   numpy only): the odometry parity solve on phase 4's bench pair (one
   problem, the clouds ring-major sorted as tests/test_parity_golden.py sorts
   them) after k = 1, 2, 5, 7, 10, 25 iterations within 3e-4 of the oracle's
   trace, on the split route and with ``COOPER_PALLAS_FUSED=1``; the
   oracle's seconds;
25. ``batch_odometry_solve(parity_mode=True)`` at B = 512 on the bench
   problem: 10 nn1, 5 nn1_masked and 5 bc_races launches, every lane finite,
   four lanes equal to a CPU run within 2e-3; steady-state solves/s of the
   parity and the native mode, timed in turns;
26. ``models/laser_odometry.step(parity_mode=True)`` over phase 9's sweeps:
   per sweep the split route's race launches and merges of phase 9, every
   pose finite, the final position error printed;
27. ``batch_scan_match(parity_mode=True)`` at B = 64 on phase 6's problem:
   22 k-NN launches, every lane finite, four lanes equal to a CPU run
   within 2e-3; then tests/test_parity_golden.py::map_scene built with the
   port's simulator and extractor at 16 x 512, at eig_threshold 10
   (non-degenerate) and 100 (degenerate): the card's trace after k = 1, 3,
   10 iterations within 2e-3 of the oracle's; the per-column sign agreement
   of the card's iteration-0 eigenvectors with numpy's is printed, and where
   a sign differs on the degenerate scene the gate holds the card to the
   oracle run with the card's signs (numpy's eigenvectors of its 6x6 system,
   signed as the card's), since the row-zeroing projector follows the signs
   (ROADMAP Queue 3);
28. ``dewarp_passes=2``: README's Quick start figure eight (phase 16's
   drive) with twice the race launches and merges per sweep, its ATE beside
   phase 16's; then the mapping pipeline at phase 17's reduced configuration
   with ``dewarp_passes=2`` on the card and the CPU (CPU-simulated sweeps):
   every merged pose within 2e-3;
29. ``extract_features_debug`` on the bench sweep (16 x 1024, simulated on
   the CPU) on the card: its clouds bit-identical to ``extract_features``',
   the picked masks' counts equal to the clouds' counts, status, label and
   region ids within their sets; against the CPU: curvature within 1e-5
   relative, status and region ids equal, labels different on at most 0.1%
   of the points (an ulp of arccos / cos decides a threshold) and the picks
   only in the rings of such a label, with the differing points printed;
30. ``SlamPipeline(mode="mapping")`` with ``matcher.dynamic_mode`` over
   tests/test_long_run.py's corridor at 16 x 1024 (``make_room_world(size=
   (30, 4, 40), n_pillars=8, seed=11)``, 60 sweeps out and 40 back at 0.5 m
   per sweep), the default config but for its ``_cfg`` map (5 x 3 x 5 cubes
   of 8 m, margin 1, capacities 768 / 1536, surround 6144 / 12288) and
   matcher (frames 2048 / 4096, ``dedup_stride=1``), ``mapping_stride=2``
   and ``score_threshold=50``: the drive's launches per sweep as phase 13's;
   its gates (at least 4 cubes flushed and 2 loaded, ``index2.txt`` and 4
   ``.pcd`` files after ``save_map``, no cube at capacity, ATE rmse below
   0.25 m, late-run success above 0.55, the native pager); the paging
   stage's ms per call and ms per sweep; then the forward leg (60 sweeps:
   the JAX test's 30 flush nothing) again with the static map: poses within
   1e-5 of the dynamic run's, which flushed cubes there, ms per sweep of
   each; then
   the native and the numpy pager out and back on the card: the same
   surround points, every point back;
31. the offline converter: phase 16's 49 sweeps placed by its merged poses,
   ``write_pcd``, ``convert_map_for_localization`` at the default
   ``MapConfig`` (one k-NN launch, k = 10, over the whole cloud); the kernel
   at that shape against ``knn_plain`` on 4096 of its queries, bit for bit;
   the card's labels against the CPU's from the same neighbours (at most
   0.1% differ, each within 1e-4 of a threshold); the surf and corner
   counts, the cube files and the points the cubes dropped; the kernel's
   card and device ms beside its bound, the plain version and the library
   chain (``cdist``, ``topk(10)``) on 1024 queries; then ``load_feature_map``
   and ``SlamPipeline(mode="localization")`` over the same sweeps from the
   first merged pose: every pose finite, the steady error printed;
32. bag replay: phase 9's sweeps as ``PointCloud2`` in the sensor's raw axis
   order, with ``Imu`` and ``Odometry`` messages, in a bz2 bag, through
   ``bag_to_npz`` (every message back); each sweep organized by
   ``organize_unordered`` (VLP16) and ``bin_sweep_native`` (16 x 1024: every
   binned point within 1.01 deg of its ring's angle, ``rel_time`` monotone
   per ring), their valid cells and ms per sweep side by side; the replay
   through ``SlamPipeline`` at ``vlp16()`` with phase 13's launch checks,
   every pose finite and the final one within 0.3 m of the simulator's;
33. one map-solving sweep of a dynamic-mode drive (the corridor's first 5)
   inside ``utils/profiling.trace``: the Chrome trace names the race kernels
   and the k-NN kernel;
34. a mesh of one rank (``parallel/distributed.initialize`` with NCCL,
   ``make_mesh()``; torch's and CUDA's versions printed), each against the
   unsharded run of the same inputs earlier in the script, bit for bit:
   ``sharded_odometry_solve`` at B = 512 on phase 4's problem (phase 4's
   launches; solves/s timed in turns with the unsharded solve, beside phase
   4's), ``sharded_scan_match`` at B = 64 on phase 7's (22 k-NN launches),
   ``sharded_pose_graph_optimize`` dense and CG on phase 18's graph (LM
   iterations/s beside phase 18's), and ``SlamPipeline(map_mesh=mesh)`` over
   phase 13's drive (phase 13's launches per sweep; the poses and
   ``single_map_state()`` against phase 13's);
35. ``bucketed_odometry_solve`` at B = 512 on the bench pair, problem b
   keeping tests/test_parallel.py's fraction 1.0 / 1.0 / 0.6 / 0.6 / 0.25 /
   0.25 [b % 6] of each cloud's points, at bench_hetero.py's granule 512
   and chunk 256, at TestBucketedOdometry's 8 GN iterations and at the
   default 25: every lane within 2e-4 of the full-capacity batch solve of
   its dispatch's problems, ``n_matched`` equal, the race launches of one
   solve per dispatch; the difference to one full-capacity solve of all
   512 by keep fraction is printed (cuBLAS's batched products sum in an
   order set by the batch size, and the problems keeping a quarter of
   their points are ill-conditioned enough to move by it); the plan and the
   solves/s of the bucketed and the homogeneous solve, timed in turns;
36. two ranks, spawned (NCCL where there are two cards, else gloo over CUDA
   tensors with both on the one card; which one ran is printed), each
   checking: the sharded odometry (256 rows each) within 1e-4 of phase 34's;
   the sharded LM dense and CG within tests/test_parallel.py's tolerances
   of phase 34's (initial cost 1e-4 relative, on the nodes those tests
   compare, 0..11: poses 5e-3, CG positions 1e-2; over every node printed);
   the striped map at the default ``MapConfig`` on phase 9's first 6
   sweeps' features (inserts and recentres, the surround, dedup and a 500 m
   recentre) bit for bit against the single-device map through
   ``to_single``, the surround as the same point set; and
   ``SlamPipeline(map_mesh)`` over phase 13's drive within 2.5e-2 m of its
   trajectory (tests/test_sharded_map.py::TestShardedPipeline's bound), with
   the stripe's bytes and each rank's peak memory; a failing rank fails
   the run and ends the other;
37. the offline runner at the HDL-64E preset: 12 sweeps of 64 x 2048 at
   the HDL-64E fan (-24.9 to 2.0 deg), 0.35 m apart in a straight line in
   the selftest's room, written as unordered ``.npz`` files in the sensor's
   axes; ``run(dir, out, sensor="hdl64", mode="mapping", stride=2,
   device="cuda")``: every pose finite, the organizer's valid cells equal
   to the points written, the first sweep's kept rings per feature class
   equal to the CPU's and each class's count within the points whose
   ``classify`` label differs from the CPU's (at most 0.1%, phase 29's
   bound; the capacity cut: the rings each class keeps are printed), the
   launches per sweep (phase 9's race launches and merges, 22
   k-NN launches per map solve), the map's cube files written; printed: the
   map solves' scores and gates, the drift against the straight ground
   truth, the StageTimer stages, ms per sweep, the peak memory and the
   smallest eigenvalue of each solve's normal matrix.  Then run() on the
   CPU over the first 4 files (a subprocess, started after phase 38 and
   checked after 39): the card's poses of sweeps 0 and 1 (the first
   odometry and map solves) within 2e-3 of the CPU's; sweeps 2 and 3,
   where these presets' thin frames let rounding grow, printed;
38. the same at the HDL-32 preset: 32 x 2048 at -30.67 to 10.67 deg;
39. ``python -m cooper_mapper_torch.examples.run_offline --selftest`` in a
   subprocess (rc 0, ``SELFTEST OK``: drift below 0.25 m), then
   ``demo_mapping``, ``demo_localization``, ``demo_graph_slam`` and
   ``demo_wander`` main() on the card at their defaults: every pose of every
   pipeline finite; their ATEs printed (the JAX demos gate none);
41. (run after 39, while 37-38's CPU runs finish, before 40's summary;
   the phase headers carry the seconds since the start) the port's reach
   against the JAX package's: the k-NN bit for bit with ``knn_plain`` at
   every k of 1..32,
   33, 63, 64, 65, 100, 127, 128, 257, 1000, 1024 and 1025 (the register
   lists up to 32, the warp select to 1024, the radix select above; and
   k = M on the grid) on the scan-to-map surf search (64 x 2048 vs 5888),
   a per-problem map, the B = 1 split shape (mapping sweep 4's surf search,
   1 x 8192 vs 65536) and a tie-heavy integer grid, with device ms, plain,
   library and bound at k = 8, 16, 32, 33, 64, 100 and 257 on the first and
   third, the select route's beside the radix design's (PERF.md);
   ``merge_first_k`` bit for bit with ``merge_first_k_plain`` and with the
   one scan on the chunk lists of the two B = 1 sweep searches as their
   plan splits them (1 x 2048 vs 32768, S = 66; 1 x 8192 vs 65536, S = 17;
   k = 5), with its ms, device ms, plain, library (``topk`` over the S x k
   candidates) and byte bound;
   every race kernel (nn1, nn1_masked "adj" and "same", bc_races,
   fused_races with and without race B) and both k-NN routes (k = 5, 40)
   at B = 65,537 against a shared and a per-problem reference, bit for bit,
   with their ms per call; then, every launch counter at 0 first, the main
   paths at the new reach: ``batch_odometry_solve`` at B = 65,537 on the
   bench pair (rows 0..511 within 1e-4 of the B = 512 solve, its solves/s),
   ``batch_scan_match`` at ``ScanMatchConfig(knn=8)``, B = 64 (four lanes
   within 2e-3 of the CPU) and ``classify_map_points`` at k = 8 and 40 on
   tests/test_io.py's scene (labels as the CPU's but within 1e-4 of a
   threshold; the test's gates at k = 8): nn1, nn1_masked, bc_races, the
   k-NN and its select route each launched;
40. a ``kernels`` JSON line (the nn1, nn1_masked, bc_races and knn rows
   carry their times at the single-stream shapes of phases 8 and 10 under
   ``single_stream``, with the split route's launches in the phase 9 drive;
   beside ``launches``, their ``merges`` count the calls that split M and
   so also launched the merge kernel; nn1's corner shape of phase 3 is under
   ``more_shapes``; the fused_races row's launches are the fused route's
   drive's, its shape the single-stream surf search and its other three
   shapes under ``more_shapes``; the merge_min row's launches are the split
   route's drive's, at S = 66 of 1024 queries with S = 32 under
   ``more_shapes``; every row's ``pipeline`` holds its launches and merges in
   phase 13's drive, its ``graph`` those inside the graph stage of phase
   20's drive, its ``parity`` those of phases 24-27's solves, its
   ``host_io`` those of phases 30-33, its ``parallel`` those of phases
   34-36 (both ranks of 36 added up) and its ``scripts`` those of phases
   37-39's drives in this process; nn1's ICP shape and the k-NN's
   fine-match shape of phase 21 and its converter shape of phase 31 are
   under their ``more_shapes``; every row's ``coverage`` holds its launches
   in phase 41's main paths and its ``wide_batch`` its B = 65,537 times;
   the knn row's ``every_k`` its times at k = 8, 16, 32; a ``knn_select``
   row, the select route, at k = 33 with 64, 100, 257 and the split shape
   under ``more_shapes``; a ``merge_first_k`` row, the split k-NN's merge,
   its launches the split route drive's k-NN merges (phase 9), its numbers
   phase 41's at S = 66 with S = 17 under ``more_shapes``), then the result
   line.

Any failed check raises, so the process exits non-zero and prints no result.
There is no CPU fallback: without a card the script stops at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, RINGS, BATCH, WORLD_SEED = 1024, 16, 512, 42
GATE = 25.0                 # OdometryConfig.nn_sq_dist_max
TIE_RTOL = 1e-5             # a true tie: two candidates' distances this close
MAX_TIE_SHARE = 1e-3        # ties allowed per race, as a share of queries
DIST_RTOL = 1e-4
CPU_LANES, CPU_TOL = 4, 2e-3   # tests/test_odometry.py's tolerance between NN paths
TRANS_TOL, ROT_TOL = 0.05, 0.01  # tests/test_odometry.py::test_recovers_motion
# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W power limit:
# HBM3 bandwidth, and FP32 outside the tensor cores, 67 TFLOP/s counting an
# FMA as two operations.  The race kernels issue no FMA (their rounding must
# equal the plain version's), so one FP32 operation takes one issue slot and
# their peak is half that: 132 SMs x 128 lanes x 1.98 GHz.
FP32_PEAK_OPS = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# FP32 operations per (query, reference) pair: 8 for d = (|q|^2 - 2 q.r) + |r|^2
# (3 mul, 2 add, 1 scale, 1 sub, 1 add), 1 compare per running minimum, and
# the ring tests ("adj": sub, 2 compares; "same": 1 compare).  The selects
# that keep (min, argmin) are left out, so the bound is a floor.
# The k-NN: 8 for d and 1 compare against the K-th best; the insertions that
# follow a successful compare are left out.
# The fused search does the function's work once per pair: 8 for d, 1 for
# A's running minimum, then C's ring test and minimum (4) and, for surf, B's
# (2): 15 (surf) or 13 (corner).  Its kernel computes d in both of its passes
# (race A by group minima, 9; then C, or B and C from one d and one ring
# difference, 12 or 14 with the settled rule), so it issues about 21 or 23:
# the bound below is the function's, not the design's.
OPS_PER_PAIR = {"nn1": 9, "nn1_masked": 12, "bc_races": 14, "knn": 9,
                "fused_races": 15, "fused_races_corner": 13}
# The pairs a search needs are every query against each VALID reference
# point: a padded slot only has its mask read (1 byte), never its xyz (12
# bytes) or ring (4).  The clouds are padded to capacity (the loop's stacked
# keyframes are ~95% padding), so counting every slot would overstate the
# work, and so loosen the bound, by that much.
# Scan-to-map path: benchmarks/bench_scan_match.py's problem and batch
SM_BATCH, SM_WORLD_SEED, SM_MAP_SWEEPS, KNN_K = 64, 7, 6, 5
# Single stream: benchmarks/bench_realtime.py's drive and LOAM's budgets
SS_SWEEPS, SS_STEP_M, SS_WORLD_SEED = 14, 0.35, 9
BUDGET_MS = {"odometry": 100.0, "mapping": 1000.0}
GT_TOL = 0.3                   # tests/test_pipeline.py::TestFusedSteps
LOC_OFFSET_X, LOC_SWEEPS = 0.8, 6


_T0 = time.perf_counter()


def log(msg):
    """Print one line; a phase's header ("[N] ...") also gets the seconds
    since the script started, so that the log shows where its time goes."""
    if msg[:1] == "[" and msg[1:msg.find("]")].isdigit():
        msg = f"{msg} (at {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


# The launch counters (``utils/profiling.COUNTS``) of the port's kernels on
# its paths at their configured k: nn1, nn1_masked, bc_races, fused_races,
# merge_min (counted where the split races launch it), knn (the register
# lists).  The k-NN's select route, taken only at k > 32, is counted apart
# (``knn.knn_select.launches``) and read in phase 41, which drives it.
KERNEL_COUNTERS = ("races.nn1", "races.nn1_masked", "races.bc_races", "races.fused_races",
                   "races.merge_min", "knn.knn")
# the split searches, which also count the calls that launched their merge
SPLIT_COUNTERS = ("races.nn1", "races.nn1_masked", "races.bc_races", "knn.knn")


def reset_launches():
    from cooper_mapper_torch.utils.profiling import COUNTS

    for k in KERNEL_COUNTERS:
        COUNTS[f"{k}.launches"] = 0
    for k in SPLIT_COUNTERS:
        COUNTS[f"{k}.merges"] = 0


def read_launches():
    from cooper_mapper_torch.utils.profiling import COUNTS

    return {k.rsplit(".", 1)[1]: COUNTS[f"{k}.launches"] for k in KERNEL_COUNTERS}


def read_merges():
    """Calls of the split searches (nn1, nn1_masked, bc_races, knn) that
    split M across blocks and so also launched their merge kernel."""
    from cooper_mapper_torch.utils.profiling import COUNTS

    return {k.rsplit(".", 1)[1]: COUNTS[f"{k}.merges"] for k in SPLIT_COUNTERS}


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[1] card: {name} | nvidia-smi: {smi}")
    return name, smi


def build_phase():
    from cooper_mapper_torch import build

    log("[2] building kernels (nvcc, one process per source, then one link)")
    t0 = time.perf_counter()
    build.library()
    wall = time.perf_counter() - t0
    nvcc = build.build_seconds
    log(f"[2] build: {wall:.2f} s wall, nvcc {nvcc if nvcc is None else round(nvcc, 2)} s")
    with open(f"{build.BUILD_DIR}/build.log") as f:
        for line in f:
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                log("    " + line.strip())
    return wall


def make_problem(device):
    """The bench sweep pair, features and compacted clouds on ``device``."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import features

    world = sim.make_room_world(seed=WORLD_SEED, device=device)
    p0 = torch.eye(4, device=device)
    p0[1, 3] = 1.5
    c, s = np.cos(0.02), np.sin(0.02)
    motion = torch.tensor([[c, 0, s, 0.1], [0, 1, 0, 0], [-s, 0, c, 0.35], [0, 0, 0, 1]],
                          dtype=torch.float32, device=device)
    cfg = RegistrationConfig(n_rings=RINGS, max_points_per_ring=WIDTH)
    f_prev = features.extract_features(sim.scan_sweep(world, p0, p0, RINGS, WIDTH), cfg)
    f_cur = features.extract_features(sim.scan_sweep(world, p0, p0 @ motion, RINGS, WIDTH), cfg)
    return (snug(f_cur.sharp), snug(f_cur.flat), snug(f_prev.less_sharp),
            snug(f_prev.less_flat), motion)


def snug(cl, granule=256):
    """``cl`` compacted to its valid count rounded up to ``granule``."""
    from cooper_mapper_torch.utils import cloud

    return cloud.compact(cl, -(-int(cl.mask.sum()) // granule) * granule)


def tile(cl, b):
    from cooper_mapper_torch.utils.cloud import Cloud

    return Cloud(*(t[None].expand((b,) + tuple(t.shape)).contiguous()
                   for t in (cl.xyz, cl.mask, cl.ring, cl.rel_time)))


def to_cpu(cl, n=None):
    """``cl`` on the CPU; its first ``n`` problems when ``n`` is given."""
    from cooper_mapper_torch.utils.cloud import Cloud

    return Cloud(*(t[:n].cpu() if n else t.cpu()
                   for t in (cl.xyz, cl.mask, cl.ring, cl.rel_time)))


def time_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, names, reps=20, tries=3):
    """(device ms per call of the kernels whose names contain one of
    ``names``, their launches per call, device ms per call of every kernel
    the call launches, and the first group's ms per call by name), from
    ``torch.profiler`` over ``reps`` calls after one warm-up.  A trace that
    lost events (a kernel seen a number of times that is not a multiple of
    ``reps``, or none of the named kernels) is taken again, up to ``tries``
    times.  Where no trace saw a named kernel, the first group's ms is None:
    not measured, never 0."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        every = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        counts = {}
        for e in every:
            counts[e.name] = counts.get(e.name, 0) + 1
        seen = any(k in name for name in counts for k in names)
        if seen and all(c % reps == 0 for c in counts.values()):
            break
    ev = [e for e in every if any(k in e.name for k in names)]
    ms = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3
    by_kernel = {k: ms([e for e in ev if k in e.name]) for k in names}
    if not ev:
        log(f"    device_ms: the profiler saw none of {names} in {tries} traces: not measured")
    return (ms(ev) if ev else None), len(ev) / reps, ms(every), \
        {k: v for k, v in by_kernel.items() if v}


def fmt_ms(x, digits=4):
    """A time for the log: ``digits`` decimals, or "not measured" for None."""
    return "not measured" if x is None else f"{x:.{digits}f}"


# the port's own search kernels, by the names the profiler shows
OWN_KERNELS = ("knn_kernel", "bc_races_kernel", "nn1_kernel", "masked_kernel",
               "fused_races_kernel", "merge_first_k", "merge_min", "knn_select_kernel",
               "knn_radix_kernel")


def compare_race(label, kernel_out, plain_out):
    """(idx, dist) pairs: equal indices inside the gate except true ties,
    distances within DIST_RTOL.  Returns the max abs distance error."""
    ik, dk = kernel_out
    ip, dp = plain_out
    torch.cuda.synchronize()
    if not (torch.isfinite(dk).all() and torch.isfinite(dp).all()):
        fail(f"{label}: non-finite distance")
    err = (dk - dp).abs()
    bad_d = int((err > DIST_RTOL * dp.abs() + 1e-6).sum())
    gated = dp < GATE
    differ = gated & (ik != ip)
    tie = differ & (err <= TIE_RTOL * dp.abs())
    n_q = ip.numel()
    n_bad_i = int((differ & ~tie).sum())
    n_tie = int(tie.sum())
    log(f"    {label}: {n_q} queries, {int(gated.sum())} gated in, index mismatches "
        f"{n_bad_i}, ties {n_tie}, distance mismatches {bad_d}, max |dd| {float(err.max()):.3g}")
    if n_bad_i or bad_d or n_tie > MAX_TIE_SHARE * n_q:
        fail(f"{label} disagrees with its plain version")
    return float(err.max())


def ref_counts(B, mask):
    """(slots, valid points) of a reference mask, [M] shared by the B
    problems or [B, M]; and the valid (query-problem, reference) pairs per
    query."""
    valid = int(mask.sum())
    return mask.numel(), valid, valid * (B if mask.dim() == 1 else 1)


def race_bytes(B, Q, slots, valid, n_out, with_ring):
    inputs = B * Q * 12 + slots + valid * 12 + (valid * 4 + B * Q * 8 if with_ring else 0)
    return inputs + n_out * B * Q * 8


def race_a_ring(q, ref):
    """(ring_a, ia): race A's winner (plain version) and its stored ring, the
    inputs of the ring races."""
    from cooper_mapper_torch.ops import neighbors, races

    ia, _ = races.nn1_plain(q, ref.xyz, ref.mask)
    return neighbors.take_ref(ref.ring, ia, ref.xyz.dim() == 2), ia


def walk_lists(q_mask, r_mask):
    """The walk lists the main path gives a race (``races.valid_list`` of the
    query and reference masks), as keyword arguments."""
    from cooper_mapper_torch.ops import races

    return dict(q_list=races.valid_list(q_mask), r_list=races.valid_list(r_mask))


def kernel_phase(sharp, flat, ref_c, ref_s, x0):
    """Each race kernel against its plain version on the main path's inputs:
    the de-warped query clouds of the first correspondence refresh, walked
    as the main path walks them (the lists of the query and reference
    masks, against the plain version given the query mask) and whole (as
    the callers without lists, the loop drive's ICP among them)."""
    from cooper_mapper_torch.ops import races
    from cooper_mapper_torch.utils import twist

    log("[3] kernels vs plain versions at the main path's shapes, listed and whole")
    qc = twist.warp_to_start(x0, sharp.xyz, sharp.rel_time).contiguous()
    qs = twist.warp_to_start(x0, flat.xyz, flat.rel_time).contiguous()
    B = qc.shape[0]
    span = 2.5
    rows = {}

    def both(label, kern, plain, args, q_mask, ref, parts=((0, 2),)):
        """The kernel listed against the plain version given ``q_mask``, and
        whole against it without; each (idx, dist) part of the answers."""
        errs = []
        for walk, k, p in (("listed", kern(*args, **walk_lists(q_mask, ref.mask)),
                            plain(*args, q_mask=q_mask)),
                           ("whole", kern(*args), plain(*args))):
            for tag, (a, b) in zip(("B", "C") if len(parts) > 1 else ("",), parts):
                errs.append(compare_race(f"{label}{' ' + tag if tag else ''} {walk}", k[a:b],
                                         p[a:b]))
        return max(errs)

    # race A: corner and surf searches, shared reference; surf per problem too
    ref_sb = tile(ref_s, B)
    errs = [both(f"nn1 {tag} {tuple(q.shape)} vs {tuple(ref.xyz.shape)}", races.nn1,
                 races.nn1_plain, (q, ref.xyz, ref.mask), qm, ref)
            for tag, q, qm, ref in (("corner", qc, sharp.mask, ref_c),
                                    ("surf", qs, flat.mask, ref_s),
                                    ("surf per-problem ref", qs, flat.mask, ref_sb))]
    rows["nn1"] = dict(err=max(errs), q=qs, q_mask=flat.mask, ref=ref_s)
    rows["nn1 corner"] = dict(err=max(errs), q=qc, q_mask=sharp.mask, ref=ref_c)

    # ring race, "adj" (corner race B, on the main path) and "same"
    ra, ia = race_a_ring(qc, ref_c)
    errs = [both(f"nn1_masked {mode} corner {tuple(qc.shape)}", races.nn1_masked,
                 races.nn1_masked_plain,
                 (qc, ra, ia, ref_c.xyz, ref_c.ring, ref_c.mask, mode, span), sharp.mask, ref_c)
            for mode in ("adj", "same")]
    rows["nn1_masked"] = dict(err=max(errs), q=qc, q_mask=sharp.mask, ref=ref_c, ra=ra, ia=ia)

    # surf races B and C, shared and per-problem reference
    errs = []
    for tag, ref in (("shared", ref_s), ("per-problem", ref_sb)):
        ra_s, ia_s = race_a_ring(qs, ref)
        errs.append(both(f"bc_races {tag}", races.bc_races, races.bc_races_plain,
                         (qs, ra_s, ia_s, ref.xyz, ref.ring, ref.mask, span), flat.mask, ref,
                         parts=((0, 2), (2, 4))))
        if tag == "shared":
            rows["bc_races"] = dict(q=qs, q_mask=flat.mask, ref=ref_s, ra=ra_s, ia=ia_s)
    rows["bc_races"]["err"] = max(errs)

    # times at the main path's shapes of each kernel (nn1: surf, then corner),
    # listed as the main path calls it
    log(f"    times ({RACE_TIMES})")
    return {name: race_times(name.split()[0], r["q"], r["ref"], r["err"], r.get("ra"),
                             r.get("ia"), span, q_mask=r["q_mask"])
            for name, r in rows.items()}


RACE_TIMES = ("CUDA events; wrapper calls, listed where the main path lists; plain = the "
              "PyTorch version on the card; library = torch.cdist chain")


def race_times(name, q, ref, err, ra=None, ia=None, span=2.5, q_mask=None):
    """A split race kernel's, plain version's and library chain's ms on a
    shared reference, beside the bound; logged and returned as a kernels-line
    row.  ``name`` is nn1, nn1_masked ("adj") or bc_races; the ring races
    take A's ring ``ra`` and index ``ia``.  With ``q_mask`` the kernel walks
    the lists of the query and reference masks, as the main path calls it,
    the plain version is given ``q_mask``, and the bound counts the valid
    queries only."""
    from cooper_mapper_torch.ops import races

    Bq, Q, _ = q.shape
    listed = {} if q_mask is None else walk_lists(q_mask, ref.mask)
    masked = {} if q_mask is None else dict(q_mask=q_mask)
    M = ref.xyz.shape[0]
    big = torch.tensor(races.BIG, device=q.device)
    rexp = ref.xyz[None].expand(Bq, M, 3)
    inval = ~ref.mask
    if name == "nn1":
        kern = lambda: races.nn1(q, ref.xyz, ref.mask, **listed)
        plain = lambda: races.nn1_plain(q, ref.xyz, ref.mask, **masked)
        lib = lambda: torch.cdist(q, rexp).square_().masked_fill_(inval, big).min(-1)
        n_out, with_ring = 1, False
    else:
        ra_f = ra.float()[..., None]
        ringf = torch.where(ref.mask, ref.ring.float(),
                            torch.tensor(races.RING_INVALID, device=q.device))
        cols = torch.arange(M, device=q.device, dtype=torch.int32)

        def adj_ok():
            rd = (ringf - ra_f).abs_()
            return (rd > 0) & (rd <= span)

        if name == "nn1_masked":
            args = (q, ra, ia, ref.xyz, ref.ring, ref.mask, "adj", span)
            kern = lambda: races.nn1_masked(*args, **listed)
            plain = lambda: races.nn1_masked_plain(*args, **masked)
            lib = lambda: torch.cdist(q, rexp).square_().masked_fill_(~adj_ok(), big).min(-1)
            n_out, with_ring = 1, True
        else:
            args = (q, ra, ia, ref.xyz, ref.ring, ref.mask, span)
            kern = lambda: races.bc_races(*args, **listed)
            plain = lambda: races.bc_races_plain(*args, **masked)

            def lib():
                d = torch.cdist(q, rexp).square_()
                same = (ringf == ra_f) & (cols != ia[..., None])
                db = d.masked_fill(~same, big).min(-1)
                return db, d.masked_fill_(~adj_ok(), big).min(-1)
            n_out, with_ring = 2, True
    ms = time_ms(kern, reps=20)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    library_ms = time_ms(lib, reps=3, warmup=1)
    slots, valid, per_query = ref_counts(Bq, ref.mask)
    n_q = Bq * Q if q_mask is None else int(q_mask.sum())
    pairs = n_q * per_query // Bq
    t_ops = pairs * OPS_PER_PAIR[name] / FP32_PEAK_OPS * 1e3
    t_bytes = race_bytes(Bq, Q, slots, valid, n_out, with_ring) / HBM_BYTES_PER_S * 1e3
    row = dict(shape=f"{Bq}x{Q} vs {M}", valid_ref=valid, pairs=pairs, err=err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    if q_mask is not None:
        row.update(walk="listed", valid_queries=n_q)
    log(f"    {name} [{Bq}x{Q} vs {M}, {valid} valid, {n_q} valid queries, {pairs:.3g} valid "
        f"pairs, {row.get('walk', 'whole')}]: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def lane_errors(x, motion):
    from cooper_mapper_torch.utils import se3, twist

    err = se3.se3_log(se3.inverse(motion)[None] @ twist.to_mat(x))
    return err[:, :3].norm(dim=-1), err[:, 3:].norm(dim=-1)


def solve_phase(sharp, flat, ref_c, ref_s, x0, motion):
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry

    cfg = OdometryConfig()
    B = x0.shape[0]
    log(f"[4] main path: batch_odometry_solve, B={B}, default OdometryConfig")
    reset_launches()
    x, st = odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg)
    torch.cuda.synchronize()
    launches, merges = read_launches(), read_merges()
    n_blocks = -(-cfg.max_iterations // cfg.refresh_every)
    expected = {"nn1": 2 * n_blocks, "nn1_masked": n_blocks, "bc_races": n_blocks,
                "fused_races": 0, "merge_min": 0, "knn": 0}
    log(f"    launches in the main-path run: {launches} (expected {expected}); of them "
        f"split with a merge launch: {merges}")
    if launches != expected or min(launches[k] for k in ("nn1", "nn1_masked", "bc_races")) <= 0:
        fail("the main path did not launch every kernel as expected")
    if not torch.isfinite(x).all():
        fail("non-finite lanes")
    log(f"    all {B} lanes finite; converged {int(st.converged.sum())}/{B}; "
        f"iterations used {int(st.iter_used.min())}..{int(st.iter_used.max())}")

    x_cpu, _ = odometry.batch_odometry_solve(
        to_cpu(sharp, CPU_LANES), to_cpu(flat, CPU_LANES), to_cpu(ref_c), to_cpu(ref_s),
        x0[:CPU_LANES].cpu(), cfg)
    dx = float((x[:CPU_LANES].cpu() - x_cpu).abs().max())
    log(f"    lanes 0..{CPU_LANES - 1} vs the CPU plain-version run: max |dx| {dx:.3g} "
        f"(tolerance {CPU_TOL})")
    if not dx <= CPU_TOL:
        fail("card and CPU solves disagree")

    te, re_ = lane_errors(x, motion)
    log(f"    default path vs ground truth (information): translation max {float(te.max()):.4f} m, "
        f"rotation max {float(re_.max()):.4f} rad")

    rng = np.random.RandomState(1)
    dts = []
    for _ in range(5):
        xr = torch.from_numpy((0.02 * rng.randn(B, 6)).astype(np.float32)).to(x0.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, xr, cfg)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    best, med = min(dts), float(np.median(dts))
    log(f"    steady state: {B / best:.1f} solves/s best, {B / med:.1f} median "
        f"({best * 1e3:.1f} / {med * 1e3:.1f} ms per batch; runs {[round(d * 1e3, 1) for d in dts]})")

    log("[5] ground truth: the same solve with cv_dewarp=False")
    xg, _ = odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0,
                                          dataclasses.replace(cfg, cv_dewarp=False))
    te, re_ = lane_errors(xg, motion)
    log(f"    translation error max {float(te.max()):.4f} m (< {TRANS_TOL}), "
        f"rotation error max {float(re_.max()):.5f} rad (< {ROT_TOL})")
    if not (torch.isfinite(xg).all() and (te < TRANS_TOL).all() and (re_ < ROT_TOL).all()):
        fail("lanes outside the ground-truth bounds")
    return launches, merges, B / best, B / med, (x, st)


def scan_match_poses():
    """benchmarks/bench_scan_match.build_problem's poses as numpy f32 [4, 4]:
    the frame's start and end poses p0, p1 and the map sweeps' poses, drawn
    around p0 from RandomState(3) in the same order."""
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    th = 0.02
    motion = np.array([[np.cos(th), 0, np.sin(th), 0.1], [0, 1, 0, 0],
                       [-np.sin(th), 0, np.cos(th), 0.3], [0, 0, 0, 1]], np.float32)
    rng = np.random.RandomState(3)
    poses = []
    for _ in range(SM_MAP_SWEEPS):
        pk = p0.copy()
        pk[:3, 3] += np.array([rng.uniform(-1.5, 1.5), rng.uniform(-0.2, 0.2),
                               rng.uniform(-1.5, 1.5)], np.float32)
        yaw = rng.uniform(-0.4, 0.4)
        c, s = np.cos(yaw), np.sin(yaw)
        poses.append(pk @ np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                                    [0, 0, 0, 1]], np.float32))
    return p0, p0 @ motion, poses


def scan_match_clouds(map_feats, map_poses, frame_feats):
    """The scan-to-map problem from feature clouds, as
    bench_scan_match.build_problem makes it: the map sweeps' less_sharp /
    less_flat clouds taken to the world frame, concatenated and voxel-filtered
    (0.2 / 0.4 m leaves, 8192 / 16384 points); the frame's through
    ``prepare_frame`` (2048 / 4096 points); all four snug to 256 granules.
    Returns (corner, surf, ref_corner, ref_surf)."""
    from cooper_mapper_torch.config import MatcherConfig
    from cooper_mapper_torch.models import laser_mapping
    from cooper_mapper_torch.ops.voxel import voxel_downsample
    from cooper_mapper_torch.utils import cloud

    def world(field, leaf, capacity):
        parts = [laser_mapping._to_world(getattr(f, field), T)
                 for f, T in zip(map_feats, map_poses)]
        cat = cloud.make(torch.cat([p.xyz for p in parts]), torch.cat([p.mask for p in parts]))
        return voxel_downsample(cat, leaf, capacity)

    corner, surf = laser_mapping.prepare_frame(
        frame_feats.less_sharp, frame_feats.less_flat,
        MatcherConfig(max_frame_corner=2048, max_frame_surf=4096))
    return (snug(corner), snug(surf), snug(world("less_sharp", 0.2, 8192)),
            snug(world("less_flat", 0.4, 16384)))


def make_scan_match_problem(device):
    """The scan-to-map problem on ``device``, built with the port's own
    simulator and feature extraction."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import features

    world = sim.make_room_world(seed=SM_WORLD_SEED, device=device)
    cfg = RegistrationConfig(n_rings=RINGS, max_points_per_ring=WIDTH)
    p0, p1, poses = scan_match_poses()
    T = lambda p: torch.from_numpy(p).to(device)
    feats = lambda a, b: features.extract_features(
        sim.scan_sweep(world, T(a), T(b), RINGS, WIDTH), cfg)
    return scan_match_clouds([feats(p, p) for p in poses], [T(p) for p in poses],
                             feats(p0, p1))


def knn_kernel_phase(corner, surf, ref_c, ref_s, x0):
    """The k-NN kernel against knn_plain, bit for bit: the scan-to-map path's
    two searches at the first residual build (frames registered at x0), a
    per-problem reference, a ragged shape and duplicates across tiles."""
    from cooper_mapper_torch.ops import knn
    from cooper_mapper_torch.utils import twist

    log("    k-NN kernel vs knn_plain (indices and distances must be bit-identical)")
    B = x0.shape[0]
    dev = x0.device
    qc = twist.point_to_map(x0, corner.xyz)
    qs = twist.point_to_map(x0, surf.xyz)
    rng = np.random.RandomState(5)
    rand = lambda *shape: torch.from_numpy(rng.uniform(-8, 8, shape).astype(np.float32)).to(dev)
    nb = min(8, B)
    ref_sb = tile(ref_s, nb)
    dup_r = torch.tensor([[1.0, 2.0, 3.0]], device=dev).repeat(1300, 1)
    dup_q = torch.tensor([[1.0, 2.0, 3.0]], device=dev).repeat(2, 130, 1)
    cases = [
        ("surf", qs, ref_s.xyz, ref_s.mask),
        ("corner", qc, ref_c.xyz, ref_c.mask),
        ("surf per-problem ref", qs[:nb].contiguous(), ref_sb.xyz, ref_sb.mask),
        ("ragged Q=333 M=1000", rand(3, 333, 3), rand(1000, 3),
         torch.from_numpy(rng.rand(1000) > 0.1).to(dev)),
        ("duplicates across tiles", dup_q, dup_r, torch.ones(1300, dtype=torch.bool, device=dev)),
    ]
    err = 0.0
    for label, q, r, m in cases:
        ik, dk = knn.knn(q, r, m, KNN_K)
        ip, dp = knn.knn_plain(q, r, m, KNN_K)
        torch.cuda.synchronize()
        n_bad = int((ik != ip).sum())
        d_err = float((dk - dp).abs().max())
        log(f"    knn {label} {tuple(q.shape)} vs {tuple(r.shape)}: index mismatches {n_bad}, "
            f"max |dd| {d_err:.3g}, 5th-NN inside the 5 m^2 gate "
            f"{float((dp[..., -1] < 5.0).float().mean()):.3f}")
        if n_bad or not torch.equal(dk, dp):
            fail(f"knn {label} disagrees with knn_plain")
        if label.startswith("duplicates") and not (
                ik == torch.arange(KNN_K, device=dev, dtype=torch.int32)).all():
            fail("knn duplicates: expected indices 0..4, the smaller index first")
        err = max(err, d_err)

    log(f"    times ({KNN_TIMES})")
    return {tag: knn_times(tag, q, ref, err)
            for tag, q, ref in (("surf", qs, ref_s), ("corner", qc, ref_c))}


KNN_TIMES = ("CUDA events; wrapper calls; plain = knn_plain on the card; "
             "library = torch.cdist(...).square_().masked_fill_(...).topk(5)")


def knn_times(tag, q, ref, err, k=KNN_K, reps=20, device_names=None):
    """The k-NN kernel's, plain version's and library chain's ms on a shared
    reference at k, beside the bound; logged and returned as a kernels-line
    row.  With ``device_names``, also the device ms per call of the kernels
    so named (``device_ms``)."""
    from cooper_mapper_torch.ops import knn, races

    B, Q, _ = q.shape
    M = ref.xyz.shape[0]
    rexp = ref.xyz[None].expand(B, M, 3)
    inval = ~ref.mask
    big = torch.tensor(races.BIG, device=q.device)
    call = lambda: knn.knn(q, ref.xyz, ref.mask, k)
    ms = time_ms(call, reps=reps)
    plain_ms = time_ms(lambda: knn.knn_plain(q, ref.xyz, ref.mask, k), reps=3, warmup=1)
    library_ms = time_ms(lambda: torch.cdist(q, rexp).square_().masked_fill_(inval, big)
                         .topk(k, largest=False), reps=3, warmup=1)
    slots, valid, per_query = ref_counts(B, ref.mask)
    pairs = Q * per_query
    t_ops = pairs * OPS_PER_PAIR["knn"] / FP32_PEAK_OPS * 1e3
    t_bytes = (B * Q * 12 + slots + valid * 12 + B * Q * k * 8) / HBM_BYTES_PER_S * 1e3
    row = dict(shape=f"{B}x{Q} vs {M}", k=k, valid_ref=valid, pairs=pairs, err=err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    dev = ""
    if device_names:
        row["device_ms"], _, _, _ = device_ms(call, device_names, reps=reps)
        dev = f", device {fmt_ms(row['device_ms'])} ms"
    log(f"    knn {tag} k={k} [{B}x{Q} vs {M}, {valid} valid, {pairs:.3g} valid pairs]: kernel "
        f"{ms:.4f} ms{dev}, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def scan_match_phase(corner, surf, ref_c, ref_s, x0):
    from cooper_mapper_torch.config import ScanMatchConfig
    from cooper_mapper_torch.ops import scan_match as sm

    cfg = ScanMatchConfig()
    B = x0.shape[0]
    log(f"[7] scan-to-map path: batch_scan_match, B={B}, default ScanMatchConfig, shared map")
    corner_b, surf_b = tile(corner, B), tile(surf, B)
    reset_launches()
    res = sm.batch_scan_match(corner_b, surf_b, ref_c, ref_s, x0, cfg)
    torch.cuda.synchronize()
    launches, merges = read_launches(), read_merges()
    expected = {"nn1": 0, "nn1_masked": 0, "bc_races": 0, "fused_races": 0, "merge_min": 0,
                "knn": 2 * (cfg.max_iterations + 1)}
    log(f"    launches in the scan-to-map run: {launches} (expected {expected}); of them "
        f"split with a merge launch: {merges}")
    if launches != expected:
        fail("the scan-to-map path did not launch the k-NN kernel as expected")
    if not torch.isfinite(res.x).all():
        fail("non-finite scan-to-map lanes")
    if not bool(res.success.all()):
        fail(f"scan-to-map lanes without success: {int((~res.success).sum())} of {B}")
    rng_of = lambda t: f"{float(t.min()):.6g}..{float(t.max()):.6g}"
    log(f"    all {B} lanes finite and success; score {rng_of(res.score)}, match fraction "
        f"{rng_of(res.match_fraction)}, iterations used {rng_of(res.iter_used)}, "
        f"degenerate {int(res.is_degenerate.sum())}")

    res_cpu = sm.batch_scan_match(to_cpu(corner_b, CPU_LANES), to_cpu(surf_b, CPU_LANES),
                                  to_cpu(ref_c), to_cpu(ref_s), x0[:CPU_LANES].cpu(), cfg)
    dx = float((res.x[:CPU_LANES].cpu() - res_cpu.x).abs().max())
    log(f"    lanes 0..{CPU_LANES - 1} vs the CPU plain-version run: max |dx| {dx:.3g} "
        f"(tolerance {CPU_TOL}); CPU success {res_cpu.success.tolist()}")
    if not (dx <= CPU_TOL and bool(res_cpu.success.all())):
        fail("card and CPU scan-to-map solves disagree")

    rng = np.random.RandomState(1)
    dts = []
    for _ in range(5):
        xr = torch.from_numpy((0.02 * rng.randn(B, 6)).astype(np.float32)).to(x0.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm.batch_scan_match(corner_b, surf_b, ref_c, ref_s, xr, cfg)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    best, med = min(dts), float(np.median(dts))
    log(f"    steady state: {B / best:.1f} solves/s best, {B / med:.1f} median "
        f"({best * 1e3:.1f} / {med * 1e3:.1f} ms per batch; runs {[round(d * 1e3, 1) for d in dts]})")

    loc = sm.scan_match_local(corner, surf, ref_c, ref_s, x0[0], cfg)
    loc_cpu = sm.scan_match_local(to_cpu(corner), to_cpu(surf), to_cpu(ref_c), to_cpu(ref_s),
                                  x0[0].cpu(), cfg)
    dx = float((loc.x.cpu() - loc_cpu.x).abs().max())
    log(f"    scan_match_local lane 0: success {bool(loc.success)} (CPU {bool(loc_cpu.success)}), "
        f"max |dx| vs CPU {dx:.3g}")
    if not (torch.isfinite(loc.x).all() and dx <= CPU_TOL
            and bool(loc.success) == bool(loc_cpu.success)):
        fail("scan_match_local on the card disagrees with the CPU")
    return launches, merges, B / best, B / med, res


def fused_bytes(B, Q, slots, valid, n_races):
    """Bytes the fused search must move: queries, the reference (every
    mask; xyz and ring of the valid points), one (index, distance) pair per
    race and query."""
    return B * Q * 12 + slots + valid * 16 + n_races * B * Q * 8


def compare_exact(label, got, want, where=None):
    """Index and distance tuples equal bit for bit (on ``where`` if given)."""
    torch.cuda.synchronize()
    sel = (lambda t: t[where]) if where is not None else (lambda t: t)
    n_bad = sum(int((sel(g) != sel(w)).sum()) for g, w in zip(got[0::2], want[0::2]))
    d_err = max(float((sel(g) - sel(w)).abs().max()) for g, w in zip(got[1::2], want[1::2]))
    n_q = got[0].numel() if where is None else int(where.sum())
    log(f"    {label}: {n_q} queries, index mismatches {n_bad}, max |dd| {d_err:.3g}")
    if n_bad or not all(torch.equal(sel(g), sel(w)) for g, w in zip(got[1::2], want[1::2])):
        fail(f"{label}: the kernel disagrees")
    return d_err


def fused_kernel_phase(stream_clouds, bench_clouds):
    """The fused kernel against its plain version and the split kernels, at
    the single-stream shapes (B = 1) and the odometry bench shapes (B = 512),
    with a per-problem reference and a ragged M; the split kernels against
    their plain versions at the B = 1 shapes; then the fused kernel's times."""
    from cooper_mapper_torch.ops import neighbors, races

    log("[8] fused race kernel vs its plain version and the split kernels")
    span = 2.5
    dev = stream_clouds[0].device
    rng = np.random.RandomState(8)
    rand = lambda *shape: torch.from_numpy(rng.uniform(-8, 8, shape).astype(np.float32)).to(dev)
    ragged_ref = (rand(1000, 3), torch.from_numpy(rng.randint(0, 16, 1000).astype(np.int32)).to(dev),
                  torch.from_numpy(rng.rand(1000) > 0.1).to(dev))
    sq, fq, c_ref, s_ref, sq_mask, fq_mask = stream_clouds
    bsharp, bflat, b_ref_c, b_ref_s = bench_clouds
    nb = min(8, bflat.shape[0])
    b_ref_sb = tile(b_ref_s, nb)
    cases = [
        ("single-stream corner", sq, c_ref, False),
        ("single-stream surf", fq, s_ref, True),
        ("bench corner", bsharp, b_ref_c, False),
        ("bench surf", bflat, b_ref_s, True),
        ("bench surf per-problem ref", bflat[:nb].contiguous(), b_ref_sb, True),
        ("ragged Q=333 M=1000", rand(3, 333, 3), None, True),
    ]
    err = 0.0
    single = {}
    for label, q, ref, with_same in cases:
        xyz, ring, mask = ragged_ref if ref is None else (ref.xyz, ref.ring, ref.mask)
        shared = xyz.dim() == 2
        got = races.fused_races(q, xyz, ring, mask, with_same, span)
        err = max(err, compare_exact(f"{label} {tuple(q.shape)} vs {tuple(xyz.shape)} vs plain",
                                     got, races.fused_races_plain(q, xyz, ring, mask, with_same,
                                                                  span)))
        ia, da = races.nn1(q, xyz, mask)
        ring_a = neighbors.take_ref(ring, ia, shared)
        split = (ia, da) + (races.bc_races(q, ring_a, ia, xyz, ring, mask, span) if with_same
                            else races.nn1_masked(q, ring_a, ia, xyz, ring, mask, "adj", span))
        a_valid = neighbors.take_ref(mask, ia, shared)
        compare_exact(f"{label} vs the split kernels where A is valid", got, split, a_valid)
        if label.startswith("single-stream"):
            # the split route's launches at B = 1, every query
            a_err = compare_exact(f"{label} nn1 vs nn1_plain", (ia, da),
                                  races.nn1_plain(q, xyz, mask))
            plain = (races.bc_races_plain(q, ring_a, ia, xyz, ring, mask, span) if with_same
                     else races.nn1_masked_plain(q, ring_a, ia, xyz, ring, mask, "adj", span))
            d_err = compare_exact(
                f"{label} {'bc_races' if with_same else 'nn1_masked adj'} vs plain",
                split[2:], plain)
            # and as the single-stream drive calls them: listed (M split)
            q_mask = sq_mask if ref is c_ref else fq_mask
            walk = walk_lists(q_mask, mask)
            ia_l, da_l = races.nn1(q, xyz, mask, **walk)
            a_err = max(a_err, compare_exact(f"{label} nn1 listed vs nn1_plain", (ia_l, da_l),
                                             races.nn1_plain(q, xyz, mask, q_mask)))
            ring_l = neighbors.take_ref(ring, ia_l, shared)
            args = (q, ring_l, ia_l, xyz, ring, mask)
            listed = (races.bc_races(*args, span, **walk) if with_same
                      else races.nn1_masked(*args, "adj", span, **walk))
            plain = (races.bc_races_plain(*args, span, q_mask) if with_same
                     else races.nn1_masked_plain(*args, "adj", span, q_mask))
            d_err = max(d_err, compare_exact(
                f"{label} {'bc_races' if with_same else 'nn1_masked adj'} listed vs plain",
                listed, plain))
            single[label] = (q, ref, a_err, d_err, ring_a, ia, q_mask)

    log("    times (CUDA events; plain = fused_races_plain on the card; library = "
        "torch.cdist chain: min, ring gather, masked mins)")
    big = torch.tensor(races.BIG, device=dev)
    out = {}
    for label, q, ref, with_same in cases[:4]:
        B, Q, _ = q.shape
        M = ref.xyz.shape[0]
        rexp = ref.xyz[None].expand(B, M, 3)
        inval = ~ref.mask
        ringf = torch.where(ref.mask, ref.ring.float(), torch.tensor(races.RING_INVALID, device=dev))
        cols = torch.arange(M, device=dev)

        def lib():
            d = torch.cdist(q, rexp).square_().masked_fill_(inval, big)
            da, ia = d.min(-1)
            ra = ringf[ia][..., None]
            res = [(da, ia)]
            if with_same:
                same = (ringf == ra) & (cols != ia[..., None])
                res.append(d.masked_fill(~same, big).min(-1))
            rd = (ringf - ra).abs_()
            res.append(d.masked_fill_(~((rd > 0) & (rd <= span)), big).min(-1))
            return res

        args = (q, ref.xyz, ref.ring, ref.mask, with_same, span)
        shared = ref.xyz.dim() == 2

        def split_route():
            ia, da = races.nn1(q, ref.xyz, ref.mask)
            ring_a = neighbors.take_ref(ref.ring, ia, shared)
            if with_same:
                return races.bc_races(q, ring_a, ia, ref.xyz, ref.ring, ref.mask, span)
            return races.nn1_masked(q, ring_a, ia, ref.xyz, ref.ring, ref.mask, "adj", span)

        dev_ms, _, dev_all, _ = device_ms(lambda: races.fused_races(*args), OWN_KERNELS)
        split_ms, _, split_all, split_by = device_ms(split_route, OWN_KERNELS)
        ms = time_ms(lambda: races.fused_races(*args), reps=20)
        plain_ms = time_ms(lambda: races.fused_races_plain(*args), reps=3, warmup=1)
        library_ms = time_ms(lib, reps=3, warmup=1)
        slots, valid, per_query = ref_counts(B, ref.mask)
        pairs = Q * per_query
        t_ops = pairs * OPS_PER_PAIR["fused_races" if with_same else "fused_races_corner"] \
            / FP32_PEAK_OPS * 1e3
        t_bytes = fused_bytes(B, Q, slots, valid, 3 if with_same else 2) / HBM_BYTES_PER_S * 1e3
        G, qpt = races._fused_plan(B, Q, races.sm_count(dev))
        row = dict(shape=f"{B}x{Q} vs {M}", valid_ref=valid, pairs=pairs, err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", plan=[G, qpt],
                   device_ms=dev_ms, device_ms_all_kernels=dev_all,
                   split_route_device_ms=split_ms, split_route_device_ms_all_kernels=split_all,
                   split_route_device_ms_by_kernel=split_by)
        out[label] = row
        log(f"    fused_races {label} [{row['shape']}, {valid} valid, {pairs:.3g} valid pairs, "
            f"G={G} lanes per query, {qpt} per thread, blocks {-(-Q // (128 // G * qpt)) * B}]: kernel "
            f"{ms:.4f} ms (device {fmt_ms(dev_ms)}; every kernel of the call {dev_all:.4f}), "
            f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); the split route's device ms "
            f"{fmt_ms(split_ms)} ({split_by}; with the ring gather {split_all:.4f})")
    log(f"    the split kernels at the single-stream shapes, M split across blocks "
        f"({RACE_TIMES})")
    q, ref, a_err, d_err, ring_a, ia, q_mask = single["single-stream surf"]
    out["bc_races single-stream"] = race_times("bc_races", q, ref, d_err, ring_a, ia, span,
                                               q_mask=q_mask)
    out["nn1 single-stream surf"] = race_times("nn1", q, ref, a_err, q_mask=q_mask)
    q, ref, a_err, d_err, ring_a, ia, q_mask = single["single-stream corner"]
    out["nn1 single-stream corner"] = race_times("nn1", q, ref, a_err, q_mask=q_mask)
    out["nn1_masked single-stream"] = race_times("nn1_masked", q, ref, d_err, ring_a, ia, span,
                                                 q_mask=q_mask)
    out.update(merge_phase(single))
    return out


def chunk_partials(q, ref, S, race, ra=None, ia=None):
    """The (min, argmin) pairs [searches, S, Q] that a race split into S
    chunks writes before merge_min: the plain race over each chunk of the
    reference, indices offset (B = 1, shared reference); ``race`` is "nn1"
    or "bc_races" (two searches, with A's ring ``ra`` and index ``ia``)."""
    from cooper_mapper_torch.ops import races

    M = ref.xyz.shape[0]
    L = -(-M // S)
    parts = []
    for z in range(S):
        a, b = z * L, min(M, (z + 1) * L)
        x, m, rg = (t[a:b].contiguous() for t in (ref.xyz, ref.mask, ref.ring))
        if race == "nn1":
            i, d = races.nn1_plain(q, x, m)
            parts.append([(i + a, d)])
        else:
            ib, db, ic, dc = races.bc_races_plain(q, ra, ia - a, x, rg, m, 2.5)
            parts.append([(ib + a, db), (ic + a, dc)])
    pd = torch.stack([torch.stack([p[k][1][0] for p in parts]) for k in range(len(parts[0]))])
    pi = torch.stack([torch.stack([p[k][0][0] for p in parts]) for k in range(len(parts[0]))])
    return pd.contiguous(), pi.contiguous()


def merge_phase(single):
    """merge_min against its plain version, bit for bit, on the chunks'
    results of the split races at the single-stream shapes: nn1 at 1 x 1024
    vs 8192 as its plan splits it (S = 66) and into S = 32, nn1 at 1 x 256
    vs 2048 (S = 32), bc_races' two searches at 1 x 1024 (S = 66); its
    times as kernels-line rows ("merge S=..")."""
    from cooper_mapper_torch.build import library
    from cooper_mapper_torch.ops import races

    q_s, ref_s, _, _, ring_a, ia, _ = single["single-stream surf"]
    q_c, ref_c = single["single-stream corner"][:2]
    n_sm = races.sm_count(q_s.device)
    plan = lambda q, ref, bq: races._split_plan(1, q.shape[1], ref.xyz.shape[0], n_sm, bq)[0]
    nn1_bq = library().cooper_nn1_block_queries()
    S_s, S_c = plan(q_s, ref_s, nn1_bq), plan(q_c, ref_c, nn1_bq)
    S_bc = plan(q_s, ref_s, library().cooper_bc_races_block_queries())
    cases = [(f"S={S_s} n={q_s.shape[1]}", chunk_partials(q_s, ref_s, S_s, "nn1")),
             (f"S=32 n={q_s.shape[1]}", chunk_partials(q_s, ref_s, 32, "nn1")),
             (f"S={S_c} n={q_c.shape[1]}", chunk_partials(q_c, ref_c, S_c, "nn1")),
             (f"S={S_bc} n={q_s.shape[1]} x2 (bc_races)",
              chunk_partials(q_s, ref_s, S_bc, "bc_races", ring_a, ia))]
    log("    merge_min vs merge_min_plain on the split races' chunk results; times (CUDA events; "
        "device ms from the profiler; library = part_d.min(1), the reduction alone)")
    rows = {}
    for tag, (pd, pi) in cases:
        err = compare_exact(f"merge_min {tag}", races.merge_min(pd, pi),
                            races.merge_min_plain(pd, pi))
        searches, S, n = pd.shape
        ms = time_ms(lambda: races.merge_min(pd, pi), reps=20)
        dev_ms = device_ms(lambda: races.merge_min(pd, pi), ("merge_min",))[0]
        plain_ms = time_ms(lambda: races.merge_min_plain(pd, pi), reps=3, warmup=1)
        library_ms = time_ms(lambda: pd.min(1), reps=3, warmup=1)
        t_bytes = (searches * S * n * 8 + searches * n * 8) / HBM_BYTES_PER_S * 1e3
        rows[f"merge {tag}"] = row = dict(
            shape=f"{searches}x{S}x{n}", err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=t_bytes, bound_by="bytes")
        log(f"    merge_min {tag}: kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
            f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {t_bytes:.5f} ms (bytes)")
    return rows


def build_sweeps(device, n=SS_SWEEPS, width=WIDTH, n_rings=RINGS, size=(30.0, 4.0, 60.0),
                 n_pillars=10, seed=SS_WORLD_SEED, start_x=0.0):
    """benchmarks/bench_realtime.build_sweeps, ported: a straight drive, one
    sweep per SS_STEP_M forward.  Returns (sweeps, poses): poses[i] is the
    start pose of sweep i (numpy [4, 4]), poses[n] the end of the last."""
    from cooper_mapper_torch.io import sim

    world = sim.make_room_world(size=size, n_pillars=n_pillars, seed=seed, device=device)
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = start_x
    p[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = SS_STEP_M
    poses, sweeps = [p], []
    for _ in range(n):
        p2 = poses[-1] @ step
        sweeps.append(sim.scan_sweep(world, torch.from_numpy(poses[-1]).to(device),
                                     torch.from_numpy(p2).to(device), n_rings, width))
        poses.append(p2)
    return sweeps, poses


def drive_stream(cfg, sweeps, device, fused_route, label, check_launches=True):
    """init_sweep, then odometry_sweep / mapping_sweep (mapping on every
    cfg.mapping_stride-th sweep: every second at the default, as
    bench_realtime does) on ``device``.  Returns the state, the
    poses [n-1, 4, 4], the mapping successes, the ms per sweep of each kind
    from sweep 3 on, and the launches of the whole drive (under "merges": the
    split searches' calls that also launched a merge)."""
    import os

    from cooper_mapper_torch.models import fused

    os.environ["COOPER_PALLAS_FUSED"] = "1" if fused_route else "0"
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    race = ({"nn1": 0, "nn1_masked": 0, "bc_races": 0, "fused_races": 10} if fused_route
            else {"nn1": 10, "nn1_masked": 5, "bc_races": 5, "fused_races": 0})
    race_merges = split_race_merges(cfg, race["bc_races"], device) if on_card else {}
    race["merge_min"] = sum(race_merges.values())   # one launch per merging call
    reset_launches()
    total = dict.fromkeys(read_launches(), 0)
    stride = max(cfg.mapping_stride, 1)
    st = fused.create(cfg, device=device)
    poses, oks, ms = [], [], {"odometry": [], "mapping": []}
    try:
        for i, sw in enumerate(sweeps):
            before, before_m = read_launches(), read_merges()
            sync()
            t0 = time.perf_counter()
            if i == 0:
                st = fused.init_sweep(st, sw, cfg)
            elif i % stride == 0:
                st, W, ok = fused.mapping_sweep(st, sw, cfg)
            else:
                st, W, _ = fused.odometry_sweep(st, sw, cfg)
            sync()
            dt = (time.perf_counter() - t0) * 1e3
            if i == 0:
                continue
            kind = "mapping" if i % stride == 0 else "odometry"
            if i >= 3:
                ms[kind].append(dt)
            poses.append(W.cpu().numpy())
            if kind == "mapping":
                oks.append(bool(ok))
            after = read_launches()
            got = {k: after[k] - before[k] for k in after}
            for k in got:
                total[k] += got[k]
            want = dict(race, knn=2 * (cfg.scan_match.max_iterations + 1) if kind == "mapping" else 0)
            if check_launches and got != want:
                fail(f"{label}: sweep {i} ({kind}) launched {got}, expected {want}")
            after_m = read_merges()
            got_m = {k: after_m[k] - before_m[k] for k in race_merges}
            if check_launches and got_m != race_merges:
                fail(f"{label}: sweep {i} ({kind}) merged {got_m}, expected {race_merges}")
    finally:
        os.environ["COOPER_PALLAS_FUSED"] = "0"
    return st, np.stack(poses), oks, ms, dict(total, merges=read_merges())


def split_race_merges(cfg, refreshes, device):
    """Merge launches per sweep of the split route's races at B = 1, as
    ``_split_plan`` implies them for the sweep's shapes (queries: sharp /
    flat capacity; reference: less_sharp / less_flat) over ``refreshes``
    correspondence refreshes: a call merges where its plan splits M."""
    from cooper_mapper_torch.build import library
    from cooper_mapper_torch.ops import races

    lib, reg = library(), cfg.registration
    n_sm = races.sm_count(device)
    split = lambda Q, M, bq: int(races._split_plan(1, Q, M, n_sm, bq)[0] > 1)
    corner, surf = (reg.max_sharp, reg.max_less_sharp), (reg.max_flat, reg.max_less_flat)
    nn1_bq = lib.cooper_nn1_block_queries()   # nn1 and nn1_masked
    return {"nn1": refreshes * (split(*corner, nn1_bq) + split(*surf, nn1_bq)),
            "nn1_masked": refreshes * split(*corner, nn1_bq),
            "bc_races": refreshes * split(*surf, lib.cooper_bc_races_block_queries())}


def map_bytes(m):
    return sum(t.numel() * t.element_size() for cc in (m.corner, m.surf)
               for t in (cc.rows, cc.row_mask, cc.count)) + m.origin.numel() * 4


def make_stream(device):
    """The single-stream drive's sweeps and truth at the default
    PipelineConfig, and the fused search's inputs at its shapes: sweep 1's
    sharp / flat queries against sweep 0's less-sharp / less-flat clouds."""
    from cooper_mapper_torch.config import PipelineConfig
    from cooper_mapper_torch.ops import features

    cfg = PipelineConfig()
    sweeps, truth = build_sweeps(device)
    f0 = features.extract_features(sweeps[0], cfg.registration)
    f1 = features.extract_features(sweeps[1], cfg.registration)
    clouds = (f1.sharp.xyz[None].contiguous(), f1.flat.xyz[None].contiguous(),
              f0.less_sharp, f0.less_flat, f1.sharp.mask[None], f1.flat.mask[None])
    return cfg, sweeps, truth, clouds


def stream_phase(cfg, sweeps, truth, device):
    """The single-stream drive at the default PipelineConfig on both routes."""
    log(f"[9] single stream: {len(sweeps)} sweeps of {tuple(sweeps[0].mask.shape)}, {SS_STEP_M} m "
        f"per sweep, mapping every {cfg.mapping_stride} sweeps, {'default ' * (cfg == type(cfg)())}"
        f"PipelineConfig, on {device}")
    runs = {}
    for route in ("split", "fused", "split again"):
        st, poses, oks, ms, launches = drive_stream(cfg, sweeps, device, route == "fused",
                                                    f"{route} route")
        if route == "split again":
            # the drive is deterministic: a repeat of the split route equals it
            same = bool(np.array_equal(poses, runs["split"]["poses"]))
            log(f"    split route again: poses bit-identical to the first run {same}, max |dW| "
                f"{float(np.abs(poses - runs['split']['poses']).max()):.3g}")
            if not same:
                fail("the single-stream drive is not deterministic on the card")
            continue
        runs[route] = dict(state=st, poses=poses, oks=oks, ms=ms, launches=launches)
        stat = {k: (min(v), float(np.median(v))) for k, v in ms.items()}
        log(f"    {route} route: launches {launches}; mapping success {oks}; ms per sweep "
            f"(best / median of sweeps 3..{SS_SWEEPS - 1}): odometry {stat['odometry'][0]:.1f} / "
            f"{stat['odometry'][1]:.1f} (budget {BUDGET_MS['odometry']:.0f}), mapping "
            f"{stat['mapping'][0]:.1f} / {stat['mapping'][1]:.1f} (budget "
            f"{BUDGET_MS['mapping']:.0f}); runs odometry {[round(x, 1) for x in ms['odometry']]}, "
            f"mapping {[round(x, 1) for x in ms['mapping']]}")
        runs[route]["stat"] = stat
    diff = float(np.abs(runs["fused"]["poses"] - runs["split"]["poses"]).max())
    bitwise = bool(np.array_equal(runs["fused"]["poses"], runs["split"]["poses"]))
    log(f"    routes: poses bit-identical {bitwise}, max |dW| {diff:.3g}")
    if not bitwise:
        fail(f"the fused and split routes' poses differ by {diff:.3g}")
    # the pose after sweep i is the sensor at the end of sweep i in the
    # frame of the end of sweep 0
    frame = np.linalg.inv(truth[1])
    gt = frame @ truth[-1]
    st = runs["split"]["state"]
    pos = runs["split"]["poses"][-1][:3, 3]
    gt_err = float(np.linalg.norm(pos - gt[:3, 3]))
    n_map = int(st.map.surf.count.sum()) + int(st.map.corner.count.sum())
    log(f"    final position {pos.round(4).tolist()} vs the simulator's "
        f"{gt[:3, 3].round(4).tolist()}: error {gt_err:.4f} m (< {GT_TOL}); map points {n_map}; "
        f"map on the card {map_bytes(st.map) / 1e6:.1f} MB")
    if not (np.isfinite(runs["split"]["poses"]).all() and gt_err < GT_TOL):
        fail("the single-stream drive left the ground-truth bound")
    if n_map <= 0:
        fail("the single-stream drive built an empty map")
    if not any(runs["split"]["oks"]):
        fail("no mapping sweep passed its gate")
    return runs, frame


def mapping_knn_inputs(cfg, sweeps, device):
    """A mapping sweep's own k-NN searches: sweep 4's prepared frame
    registered at the merge guess against the surround of the map that sweeps
    0..3 built, the first residual build's searches of that sweep's
    mapping_step, taken stage by stage.  Returns {tag: (q [1, Q, 3], frame,
    surround)} for "surf" and "corner"."""
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.models import laser_mapping, laser_odometry
    from cooper_mapper_torch.ops import features
    from cooper_mapper_torch.utils import twist

    st = drive_stream(cfg, sweeps[:4], device, False, "sweeps 0..3")[0]
    fc = features.extract_features(sweeps[4], cfg.registration)
    _, odo_out = laser_odometry.step(st.odo, fc, cfg.odometry)
    T_guess = laser_mapping.merged_pose(st.matcher, odo_out.T_sum)
    corner_ds, surf_ds = laser_mapping.prepare_frame(odo_out.corner_for_map,
                                                     odo_out.surf_for_map, cfg.matcher)
    pos = T_guess[:3, 3]
    ref_c, ref_s = fm.get_surround(fm.recenter(st.map, pos, cfg.feature_map), pos,
                                   cfg.feature_map)
    x = twist.from_mat(T_guess)[None]
    return {tag: (twist.point_to_map(x, frame.xyz[None]).contiguous(), frame, ref)
            for tag, frame, ref in (("surf", surf_ds, ref_s), ("corner", corner_ds, ref_c))}


def mapping_knn_phase(cfg, sweeps, device, keep=None):
    """The k-NN kernel against knn_plain, bit for bit, on a mapping sweep's
    own inputs (``mapping_knn_inputs``, also left in ``keep``), where it
    splits M across blocks; its times there, as kernels-line rows."""
    from cooper_mapper_torch.ops import knn, races

    log("[10] k-NN kernel vs knn_plain at the mapping sweep's shapes (sweep 4's inputs)")
    inputs = mapping_knn_inputs(cfg, sweeps, device)
    if keep is not None:
        keep.update(inputs)
    n_sm = races.sm_count(device)
    errs = {}
    for tag, (q, frame, ref) in inputs.items():
        ik, dk = knn.knn(q, ref.xyz, ref.mask, KNN_K)
        ip, dp = knn.knn_plain(q, ref.xyz, ref.mask, KNN_K)
        torch.cuda.synchronize()
        n_bad = int((ik != ip).sum())
        errs[tag] = float((dk - dp).abs().max())
        S, L = knn._split_plan(1, q.shape[1], ref.xyz.shape[0], n_sm,
                               knn_block_queries(KNN_K))
        log(f"    knn {tag} {tuple(q.shape)} ({int(frame.mask.sum())} valid) vs "
            f"{tuple(ref.xyz.shape)} ({int(ref.mask.sum())} valid), split S={S} chunks of "
            f"L={L} on {n_sm} SMs: index mismatches {n_bad}, max |dd| {errs[tag]:.3g}, valid "
            f"queries' 5th-NN inside the 5 m^2 gate "
            f"{float((dp[0, frame.mask, -1] < 5.0).float().mean()):.3f}")
        if n_bad or not torch.equal(dk, dp):
            fail(f"knn {tag} at the mapping sweep's shape disagrees with knn_plain")
    log(f"    times ({KNN_TIMES})")
    return {tag: knn_times(tag, q, ref, errs[tag]) for tag, (q, _, ref) in inputs.items()}


def knn_block_queries(k):
    from cooper_mapper_torch.build import library

    return library().cooper_knn_block_queries(k)


def localization_phase(map_state, frame, cfg, device, **world):
    """localization_step on a built map over a second drive, seeded off by
    tests/test_localization.py's perturbation; the map must not change.
    ``world`` goes to build_sweeps (the map's world and sweep width)."""
    from cooper_mapper_torch.models import laser_mapping, laser_odometry
    from cooper_mapper_torch.ops import features

    log(f"[11] localization: {LOC_SWEEPS} sweeps {LOC_OFFSET_X} m to the side, on the built map")
    before = [t.clone() for cc in (map_state.corner, map_state.surf)
              for t in (cc.rows, cc.row_mask, cc.count)] + [map_state.origin.clone()]
    sweeps, truth = build_sweeps(device, n=LOC_SWEEPS + 1, start_x=LOC_OFFSET_X, **world)
    seed_true = frame @ truth[1]        # the localization odometry starts at the end of sweep 0
    c, s = np.cos(0.035), np.sin(0.035)
    perturb = np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.2], [0, 0, 0, 1]],
                       np.float32)
    seed = (seed_true @ perturb).astype(np.float32)
    seed_err = float(np.linalg.norm(seed[:3, 3] - seed_true[:3, 3]))
    odo = laser_odometry.create(cfg.registration.max_less_sharp, cfg.registration.max_less_flat,
                                device)
    odo = laser_odometry.init_step(odo, features.extract_features(sweeps[0], cfg.registration),
                                   cfg.odometry)
    matcher = laser_mapping.seed_localization(laser_mapping.create_matcher(device),
                                              torch.from_numpy(seed).to(device), odo.T_sum)
    errs, oks = [], []
    for i, sw in enumerate(sweeps[1:], 1):
        fc = features.extract_features(sw, cfg.registration)
        odo, out = laser_odometry.step(odo, fc, cfg.odometry)
        matcher, mo = laser_mapping.localization_step(
            matcher, map_state, out.corner_for_map, out.surf_for_map, out.T_sum,
            cfg.scan_match, cfg.matcher, cfg.feature_map)
        gt = frame @ truth[i + 1]
        errs.append(float(np.linalg.norm(mo.W.cpu().numpy()[:3, 3] - gt[:3, 3])))
        oks.append(bool(mo.result.success))
    steady = float(np.mean(errs[2:]))
    after = [t for cc in (map_state.corner, map_state.surf)
             for t in (cc.rows, cc.row_mask, cc.count)] + [map_state.origin]
    unchanged = all(torch.equal(a, b) for a, b in zip(before, after))
    log(f"    seed error {seed_err:.4f} m; errors {[round(e, 4) for e in errs]}; success {oks}; "
        f"steady {steady:.4f} m (< {0.5 * seed_err:.4f}); map unchanged {unchanged}")
    if not steady < 0.5 * seed_err:
        fail("localization did not recover from the perturbed seed")
    if not unchanged:
        fail("localization wrote the map")
    return steady, seed_err


def reduced_card_vs_cpu_phase(device):
    """tests/test_pipeline.py::TestFusedSteps' configuration and drive on the
    card and on the CPU: every pose within CPU_TOL."""
    from cooper_mapper_torch import config as C

    cfg = C.PipelineConfig(
        registration=C.RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=C.ScanMatchConfig(score_threshold=50.0),
        feature_map=C.MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                                surf_cube_capacity=2048, surround_corner_capacity=8192,
                                surround_surf_capacity=16384, valid_distance=60.0),
        matcher=C.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096))
    log("[12] card vs CPU at TestFusedSteps' reduced configuration (16x512, 7x3x7 map, 6 sweeps)")
    poses = {}
    for dev in (device, "cpu"):
        sweeps, truth = build_sweeps(dev, n=6, width=512, size=(30.0, 4.0, 40.0), n_pillars=8,
                                     seed=31)
        _, poses[dev], _, _, _ = drive_stream(cfg, sweeps, dev, False, f"reduced {dev}",
                                              check_launches=dev != "cpu")
    dx = float(np.abs(poses[device] - poses["cpu"]).max())
    gt = np.linalg.inv(truth[1]) @ truth[-1]
    gt_err = float(np.linalg.norm(poses[device][-1][:3, 3] - gt[:3, 3]))
    log(f"    max |dW| card vs CPU {dx:.3g} (tolerance {CPU_TOL}); final position error "
        f"{gt_err:.4f} m")
    if not (dx <= CPU_TOL and gt_err < GT_TOL):
        fail("the card and CPU single-stream runs disagree")
    return dx


PIPE_FUSED_TOL = 0.5          # tests/test_pipeline.py::TestImuFusion
IMU_SAMPLES = 10


def imu_window(i, device):
    """TestImuFusion's IMU window for sweep i: IMU_SAMPLES samples of zero acc
    and gyro over the 0.1 s that ends at the sweep's stamp 0.1 (i + 1)."""
    from cooper_mapper_torch.fusion import imu_queue

    stamp = 0.1 * (i + 1)
    st = torch.linspace(stamp - 0.1, stamp, IMU_SAMPLES, dtype=torch.float64).to(torch.float32)
    z = torch.zeros(IMU_SAMPLES, 3, device=device)
    return stamp, imu_queue.ImuBatch(st.to(device), z, z.clone(),
                                     torch.ones(IMU_SAMPLES, dtype=torch.bool, device=device))


def drive_pipeline(pipe, sweeps, label, imu=False, check_launches=True, start=0):
    """``pipe.process`` over the sweeps (with TestImuFusion's IMU windows when
    ``imu``), every launch counter at 0 first.  Per sweep after the first it
    checks the split route's race launches (as phase 9's, once per de-warp
    pass of ``cfg.odometry.dewarp_passes``) and 2 x 11 k-NN launches where a
    map solve ran.  ``start``: the drive's index of the first sweep, where
    ``sweeps`` continue an earlier call's.  Returns (results, ms per sweep
    from sweep 3 on, the drive's launches with the split searches' merges,
    the last IMU window)."""
    on_card = pipe.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    race, knn_per_solve = sweep_launches(pipe.cfg, pipe.device)
    reset_launches()
    results, ms, window = [], [], None
    for i, sw in enumerate(sweeps, start):
        before = read_launches()
        sync()
        t0 = time.perf_counter()
        if imu:
            stamp, window = imu_window(i, pipe.device)
            r = pipe.process(sw, imu=window, stamp=stamp)
        else:
            r = pipe.process(sw)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        results.append(r)
        if i >= 3:
            ms.append(dt)
        after = read_launches()
        got = {k: after[k] - before[k] for k in after}
        want = (dict.fromkeys(after, 0) if i == 0 else
                dict(race, knn=knn_per_solve if r.mapping_success is not None else 0))
        if check_launches and got != want:
            fail(f"{label}: sweep {i} launched {got}, expected {want}")
    return results, ms, dict(read_launches(), merges=read_merges()), window


def ms_stat(ms):
    return f"{min(ms):.1f} / {float(np.median(ms)):.1f} (runs {[round(x, 1) for x in ms]})"


def maps_equal(a, b):
    """Two cube maps hold the same points, masks, counts and origin, bit for bit
    (the guard rows, which hold what inserts dropped, are left out)."""
    return all(torch.equal(x.cpu(), y.cpu()) for ca, cb in ((a.corner, b.corner), (a.surf, b.surf))
               for x, y in ((ca.xyz, cb.xyz), (ca.mask, cb.mask), (ca.count, cb.count))
               ) and torch.equal(a.origin.cpu(), b.origin.cpu())


def copy_map(m, device):
    from cooper_mapper_torch.maps.feature_map import CubeCloud, FeatureMapState

    cc = lambda c: CubeCloud(c.rows.to(device, copy=True), c.row_mask.to(device, copy=True),
                             c.count.to(device, copy=True))
    return FeatureMapState(cc(m.corner), cc(m.surf), m.origin.to(device, copy=True))


def dedup_card_vs_cpu(map_state, pos, cfg, label):
    """dedup_active on a copy of ``map_state`` on the card, again on another
    copy (a repeat), and on a CPU copy, at ``pos``: all three bit-identical."""
    from cooper_mapper_torch.maps import feature_map as fm

    runs = [fm.dedup_active(copy_map(map_state, d), pos.to(d), cfg)
            for d in (map_state.origin.device, map_state.origin.device, "cpu")]
    n = [int(r.surf.count.sum()) + int(r.corner.count.sum()) for r in runs]
    same = maps_equal(runs[0], runs[1]) and maps_equal(runs[0], runs[2])
    log(f"    {label}: dedup_active of the map on the card, again, and on the CPU: points "
        f"{int(map_state.surf.count.sum()) + int(map_state.corner.count.sum())} -> {n}; "
        f"bit-identical {same}")
    if not same:
        fail(f"{label}: dedup_active on the card is not bit-identical to the CPU or a repeat")


def pipeline_phase(sweeps, truth, device):
    """SlamPipeline, "mapping" with IMU fusion, over phase 9's sweeps at the
    default PipelineConfig but for TestImuFusion's two settings: a map solve
    on every sweep (the UKF corrects only after an accepted solve) and no
    predict cool-down."""
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    cfg = pipe13_cfg()
    log(f"[13] SlamPipeline(mode='mapping') with IMU fusion: {len(sweeps)} sweeps of phase 9, "
        f"PipelineConfig(mapping_stride=1, ukf=UKFConfig(cool_time_duration=0.0)), "
        f"{IMU_SAMPLES} IMU samples per sweep, on {device}")
    pipe = SlamPipeline(cfg, "mapping", device=device)
    results, ms, launches, window = drive_pipeline(pipe, sweeps, "pipeline", imu=True)
    st = pipe.stats()
    frame = np.linalg.inv(truth[1])
    gt = frame @ truth[-1]
    merged = results[-1].merged_pose
    gt_err = float(np.linalg.norm(merged[:3, 3] - gt[:3, 3]))
    fused = pipe.fused_pose()
    fused_err = float(np.linalg.norm(fused[:3, 3] - merged[:3, 3]))
    poses, valid = pipe.imu_rate_poses(window)
    log(f"    launches {launches}; stats {st}; timer calls {dict(pipe.timer.calls)}")
    log(f"    final merged position {merged[:3, 3].round(4).tolist()} vs the simulator's "
        f"{gt[:3, 3].round(4).tolist()}: error {gt_err:.4f} m (< {GT_TOL}); fused pose "
        f"{fused[:3, 3].round(4).tolist()}, {fused_err:.4f} m from it (< {PIPE_FUSED_TOL}); "
        f"imu_rate_poses {poses.shape}, finite {bool(np.isfinite(poses).all())}, valid "
        f"{int(valid.sum())}")
    log(f"    ms per sweep (best / median of sweeps 3..{len(sweeps) - 1}): {ms_stat(ms)}")
    log("    StageTimer report:\n" + "\n".join("      " + ln for ln in pipe.timer.report().split("\n")))
    if not (np.isfinite(np.stack(pipe.trajectory)).all() and gt_err < GT_TOL):
        fail("the pipeline drive left the ground-truth bound")
    if st["match_count"] + st["fail_match_count"] != st["mapping_solves"] or st["match_count"] < 1:
        fail(f"the pipeline's stats do not add up: {st}")
    if pipe.timer.calls["dedup"] < 1:
        fail("the pipeline drive never ran dedup_active")
    if not (np.isfinite(fused).all() and fused_err < PIPE_FUSED_TOL):
        fail("the fused UKF pose is not near the merged pose")
    if not (poses.shape == (IMU_SAMPLES, 4, 4) and np.isfinite(poses).all()):
        fail("imu_rate_poses is not finite at its shape")
    dedup_card_vs_cpu(pipe.single_map_state(), torch.from_numpy(merged[:3, 3]), cfg.feature_map,
                      "full width")
    return pipe, dict(ms=ms, launches=launches, stats=st, gt_err=gt_err, fused_err=fused_err,
                      timer=pipe.timer.report())


def local_phase(sweeps, truth, device):
    """SlamPipeline, "local", over phase 9's sweeps at the default config but
    for the window's corner slots: 2048, the corner frame's own capacity
    (max_less_sharp).  At the default 4096 the window rejects the 2048-point
    frame in both packages (tests/test_torch_pipeline.py)."""
    from cooper_mapper_torch.config import MatcherConfig, PipelineConfig
    from cooper_mapper_torch.io import evaluation
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    cfg = PipelineConfig(matcher=MatcherConfig(max_frame_corner=2048))
    log(f"[14] SlamPipeline(mode='local'), PipelineConfig(matcher=MatcherConfig("
        f"max_frame_corner=2048)), phase 9's sweeps, on {device}")
    pipe = SlamPipeline(cfg, "local", device=device)
    results, ms, launches, _ = drive_pipeline(pipe, sweeps, "local pipeline")
    frame = np.linalg.inv(truth[1])
    gt = frame @ truth[-1]
    gt_err = float(np.linalg.norm(results[-1].merged_pose[:3, 3] - gt[:3, 3]))
    ate = evaluation.pipeline_ate(np.stack(pipe.trajectory), np.stack(truth[1:]))
    log(f"    launches {launches}; stats {pipe.stats()}; final position error {gt_err:.4f} m "
        f"(< {GT_TOL}); ATE rmse {ate.rmse:.4f} m (pipeline_ate, aligned); ms per sweep "
        f"{ms_stat(ms)}")
    log("    StageTimer report:\n" + "\n".join("      " + ln for ln in pipe.timer.report().split("\n")))
    if not (np.isfinite(np.stack(pipe.trajectory)).all() and gt_err < GT_TOL):
        fail("the local-mode pipeline left the ground-truth bound")
    return dict(ms=ms, gt_err=gt_err, ate=ate.rmse)


def pipeline_localization_phase(map_state, truth, device):
    """SlamPipeline(mode='localization') on phase 13's map over phase 11's
    drive, seeded by initial_pose as phase 11 is."""
    from cooper_mapper_torch.config import PipelineConfig
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    log(f"[15] SlamPipeline(mode='localization') on phase 13's map: {LOC_SWEEPS + 1} sweeps "
        f"{LOC_OFFSET_X} m to the side, seeded by initial_pose")
    frame = np.linalg.inv(truth[1])
    before = copy_map(map_state, map_state.origin.device)
    sweeps, loc_truth = build_sweeps(device, n=LOC_SWEEPS + 1, start_x=LOC_OFFSET_X)
    seed_true = frame @ loc_truth[1]
    c, s = np.cos(0.035), np.sin(0.035)
    perturb = np.array([[c, 0, s, 0.3], [0, 1, 0, -0.1], [-s, 0, c, 0.2], [0, 0, 0, 1]],
                       np.float32)
    seed = (seed_true @ perturb).astype(np.float32)
    seed_err = float(np.linalg.norm(seed[:3, 3] - seed_true[:3, 3]))
    pipe = SlamPipeline(PipelineConfig(), "localization", map_state=map_state, initial_pose=seed,
                        device=device)
    results, ms, launches, _ = drive_pipeline(pipe, sweeps, "localization pipeline")
    errs = [float(np.linalg.norm(r.merged_pose[:3, 3] - (frame @ loc_truth[i + 1])[:3, 3]))
            for i, r in enumerate(results[1:], 1)]
    steady = float(np.mean(errs[2:]))
    unchanged = maps_equal(before, map_state)
    log(f"    launches {launches}; stats {pipe.stats()}; seed error {seed_err:.4f} m; errors "
        f"{[round(e, 4) for e in errs]}; steady {steady:.4f} m (< {0.5 * seed_err:.4f}); map "
        f"unchanged {unchanged}")
    if not steady < 0.5 * seed_err:
        fail("the localization pipeline did not recover from the perturbed seed")
    if not unchanged:
        fail("the localization pipeline wrote the map")
    return dict(steady=steady, seed_err=seed_err)


def quick_start_phase(device):
    """README.md's Quick start, in the port, on the card."""
    from cooper_mapper_torch.config import PipelineConfig
    from cooper_mapper_torch.io import evaluation, sim
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    log("[16] README Quick start: make_room_world(seed=1), figure_eight_trajectory(50), 49 sweeps, "
        "PipelineConfig(), mode 'mapping'")
    world = sim.make_room_world(seed=1, device=device)
    poses = sim.figure_eight_trajectory(50)
    pipe = SlamPipeline(PipelineConfig(), mode="mapping", device=device)
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    sweeps = []
    for i in range(49):
        sweep = sim.scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]))
        sweeps.append(sweep)
        pipe.process(sweep)
    sync()
    wall = time.perf_counter() - t0
    est, odo = np.stack(pipe.trajectory), np.stack(pipe.odom_trajectory)
    ate, ate_odo = evaluation.pipeline_ate(est, poses), evaluation.pipeline_ate(odo, poses)
    log(f"    {wall:.2f} s for 49 sweeps; stats {pipe.stats()}; pipeline_ate rmse mapping "
        f"{ate.rmse:.4f} m, odometry only {ate_odo.rmse:.4f} m (printed, not gated)")
    log("    StageTimer report:\n" + "\n".join("      " + ln for ln in pipe.timer.report().split("\n")))
    if not (np.isfinite(est).all() and np.isfinite(odo).all()):
        fail("the Quick start drive gave a non-finite pose")
    return dict(ate=ate.rmse, ate_odo=ate_odo.rmse, wall_s=wall, sweeps=sweeps, merged=est,
                poses=poses)


def reduced_pipeline_cfg(C, **changes):
    """tests/test_pipeline.py::_small_cfg."""
    return dataclasses.replace(C.PipelineConfig(
        registration=C.RegistrationConfig(n_rings=16, max_points_per_ring=512),
        scan_match=C.ScanMatchConfig(score_threshold=50.0),
        feature_map=C.MapConfig(n_cubes=(7, 3, 7), cube_size=20.0, corner_cube_capacity=1024,
                                surf_cube_capacity=2048, surround_corner_capacity=8192,
                                surround_surf_capacity=16384, valid_distance=60.0),
        matcher=C.MatcherConfig(max_frame_corner=2048, max_frame_surf=4096, dedup_stride=1),
        mapping_stride=2), **changes)


def simulate_reduced(device, n=6, width=768, speed=0.35, yaw_rate=0.02):
    """tests/test_pipeline.py::_simulate with the port's simulator."""
    from cooper_mapper_torch.io import sim

    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=21, device=device)
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3] = 1.5
    c, s = np.cos(yaw_rate), np.sin(yaw_rate)
    step = np.array([[c, 0, s, 0.2 * speed], [0, 1, 0, 0], [-s, 0, c, speed], [0, 0, 0, 1]],
                    np.float32)
    for _ in range(n):
        poses.append(poses[-1] @ step)
    return [sim.scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                           16, width) for i in range(n)]


def reduced_pipeline_card_vs_cpu_phase(device):
    """The pipeline at tests/test_pipeline.py's reduced configuration on the
    card and on the CPU, on the same sweeps (simulated on the CPU): mapping
    with dedup after every solve and IMU windows, local, and localization
    on the mapping run's map.  Then, for information, the mapping drive on
    the card's own simulated sweeps against the CPU's."""
    from cooper_mapper_torch import config as C
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.ops.features import Sweep

    log("[17] SlamPipeline card vs CPU at tests/test_pipeline.py's reduced configuration "
        "(_small_cfg, _simulate(6)): mapping (dedup_stride=1, IMU), local, localization")
    cfg = reduced_pipeline_cfg(C)
    seed = np.eye(4, dtype=np.float32)
    seed[:3, 3] = [0.1, -0.05, 0.05]
    sweeps_cpu = simulate_reduced("cpu")
    to_card = lambda sw: [Sweep(s.xyz.to(device), s.mask.to(device), s.rel_time.to(device))
                          for s in sw]
    merged = lambda results: np.stack([r.merged_pose for r in results])
    out, dx = {}, {}
    for dev, sweeps in ((device, to_card(sweeps_cpu)), ("cpu", sweeps_cpu)):
        card = dev != "cpu"
        runs = {}
        for mode, kw in (("mapping", dict(imu=True)), ("local", {})):
            pipe = SlamPipeline(cfg, mode, device=dev)
            res = drive_pipeline(pipe, sweeps, f"reduced {mode} {dev}", check_launches=card, **kw)
            runs[mode] = (pipe, res[0])
        loc_map = copy_map(runs["mapping"][0].single_map_state(), dev)
        pipe = SlamPipeline(cfg, "localization", map_state=loc_map, initial_pose=seed, device=dev)
        runs["localization"] = (pipe, drive_pipeline(pipe, sweeps, f"reduced localization {dev}",
                                                     check_launches=card)[0])
        out[dev] = runs
    for mode in ("mapping", "local", "localization"):
        dx[mode] = float(np.abs(merged(out[device][mode][1]) - merged(out["cpu"][mode][1])).max())
    fused = float(np.abs(out[device]["mapping"][0].fused_pose()
                         - out["cpu"]["mapping"][0].fused_pose()).max())
    log(f"    same sweeps: max |dW| card vs CPU per mode {dx} (tolerance {CPU_TOL}); fused pose "
        f"{fused:.3g}; stats card {out[device]['mapping'][0].stats()} / CPU "
        f"{out['cpu']['mapping'][0].stats()}")
    if not all(v <= CPU_TOL for v in dx.values()):
        fail("the pipeline on the card and on the CPU disagree")
    card_map = out[device]["mapping"][0].single_map_state()
    pos = torch.from_numpy(out[device]["mapping"][1][-1].merged_pose[:3, 3])
    dedup_card_vs_cpu(card_map, pos, cfg.feature_map, "reduced")
    # information: each device's own simulator (sin / cos round differently)
    own = simulate_reduced(device)
    d_sim = max(float((a.xyz.cpu() - b.xyz)[b.mask].abs().max()) for a, b in zip(own, sweeps_cpu))
    pipe = SlamPipeline(cfg, "mapping", device=device)
    res = drive_pipeline(pipe, own, "reduced mapping, the card's own sweeps", imu=True)[0]
    dx_own = np.abs(merged(res) - merged(out["cpu"]["mapping"][1])).max(axis=(1, 2))
    log(f"    information: the card's own simulated sweeps differ from the CPU's by up to "
        f"{d_sim:.3g} m; the mapping drive on them vs the CPU's, max |dW| per sweep "
        f"{dx_own.round(6).tolist()}")
    return dx


# Pose-graph backend: benchmarks/bench_pose_graph.py's problem, the loop drive
# of tests/test_graph_pipeline.py at full width
PG_NODES, PG_BIG_NODES, PG_PCG_ITERS, PG_REPS = 1024, 4096, 64, 2
PG_COST_RATIO = 0.2          # tests/test_pose_graph.py::test_cg_scales_to_large_graph
LOOP_SWEEPS, LOOP_NOISE, LOOP_SEED = 52, 0.03, 7
# tests/test_graph_pipeline.py::_cfg's score_threshold.  The score sums one
# term of at most 1 per frame feature, and with 0.03 m of noise at full width
# the voxel-filtered frames carry ~400-600 features, so the default 800 is
# out of reach (the JAX package scores these sweeps the same:
# tests/test_torch_loop_drive.py)
LOOP_SCORE = 50.0
GRAPH_ATE_MAX, END_SLACK = 0.25, 0.05   # tests/test_graph_pipeline.py::TestGraphInTheLoop
SAVE_LOC_TOL = 0.3


def pose_graph_problem(n, solver, device, loop_every=100, **changes):
    """(graph on ``device``, PoseGraphConfig) of ``sim.drifted_ring_graph(n)``
    (benchmarks/bench_pose_graph.build_graph) at
    max_nodes = n, max_edges = 2 n, PG_PCG_ITERS CG iterations."""
    from cooper_mapper_torch.config import PoseGraphConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import pose_graph as pg

    cfg = PoseGraphConfig(max_nodes=n, max_edges=2 * n, solver=solver, pcg_iters=PG_PCG_ITERS,
                          **changes)
    return pg.from_arrays(*sim.drifted_ring_graph(n, loop_every=loop_every), max_nodes=n,
                          max_edges=2 * n, device=device), cfg


def pose_graph_lm(n, solver, device):
    """``optimize`` on build_graph(n) at the default 50 LM iterations: the
    gates (final cost finite and below PG_COST_RATIO of the initial one, a
    repeat bit-identical, node 0 unchanged), then ms per optimize and LM
    iterations/s (max_iterations over the wall time of one optimize, host
    clock around torch.cuda.synchronize()), best and median of PG_REPS."""
    from cooper_mapper_torch.ops import pose_graph as pg

    g, cfg = pose_graph_problem(n, solver, device)
    torch.cuda.reset_peak_memory_stats()
    out, diag = pg.optimize(g, cfg)
    again, _ = pg.optimize(g, cfg)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    c0, c1, lam = (float(diag[k]) for k in ("initial_cost", "final_cost", "lambda"))
    repeat = torch.equal(out.poses, again.poses)
    node0 = torch.equal(out.poses[0], g.poses[0])
    ms = []
    for _ in range(PG_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pg.optimize(g, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    its = sorted(cfg.max_iterations / (m / 1e3) for m in ms)
    ratio = c1 / c0
    log(f"    {solver} n={n} (max_edges {2 * n}, {cfg.max_iterations} LM iterations"
        + (f", {cfg.pcg_iters} CG iterations" if solver == "cg" else
           f", [{6 * n}, {6 * n}] f32 system") + f"): cost {c0:.6g} -> {c1:.6g} (ratio "
        f"{ratio:.4g}, gate < {PG_COST_RATIO}), lambda {lam:.3g}; repeat bit-identical "
        f"{repeat}; node 0 unchanged {node0}; peak {peak_mb:.1f} MiB; ms per optimize "
        f"{ms_stat(ms)}; LM iterations/s best {its[-1]:.2f}, median "
        f"{float(np.median(its)):.2f}")
    if not (np.isfinite(c1) and ratio < PG_COST_RATIO):
        fail(f"pose graph {solver} n={n}: final cost {c1} not below {PG_COST_RATIO} x {c0}")
    if not repeat:
        fail(f"pose graph {solver} n={n}: a repeat gave other poses")
    if not node0:
        fail(f"pose graph {solver} n={n}: the gauge node moved")
    return dict(n=n, solver=solver, ms=ms, iters_per_s=(its[-1], float(np.median(its))),
                cost=(c0, c1), peak_mib=peak_mb), out.poses


def pose_graph_phase(device):
    log(f"[18] pose-graph LM: benchmarks/bench_pose_graph.build_graph({PG_NODES}) ({PG_NODES - 1} "
        f"odometry edges, {(PG_NODES - 1) // 100} loop edges), dense and CG (pcg_iters="
        f"{PG_PCG_ITERS}); CG at {PG_BIG_NODES} nodes")
    dense, p_dense = pose_graph_lm(PG_NODES, "dense", device)
    cg, p_cg = pose_graph_lm(PG_NODES, "cg", device)
    dpos = float((p_dense[:, :3, 3] - p_cg[:, :3, 3]).norm(dim=-1).max())
    log(f"    dense vs CG at n={PG_NODES}: max position difference {dpos:.4g} m")
    big, _ = pose_graph_lm(PG_BIG_NODES, "cg", device)
    return dict(dense=dense, cg=cg, cg_big=big, dense_vs_cg_m=dpos,
                poses={"dense": p_dense, "cg": p_cg})


def pose_graph_card_vs_cpu_phase(device):
    """A 64-node ring (build_graph(64, loop_every=16)), dense and CG, on the
    card and the CPU: poses within CPU_TOL and the same final lambda.  Where
    the lambdas differ, the first LM iteration at which they do is found and
    printed (a candidate accepted on one device and not on the other)."""
    from cooper_mapper_torch.ops import pose_graph as pg

    log("[19] pose-graph LM card vs CPU: build_graph(64, loop_every=16), dense and CG")
    out = {}
    for solver in ("dense", "cg"):
        runs = {}
        for dev in (device, "cpu"):
            g, cfg = pose_graph_problem(64, solver, dev, loop_every=16)
            runs[dev] = pg.optimize(g, cfg)
        dx = float((runs[device][0].poses.cpu() - runs["cpu"][0].poses).abs().max())
        lams = [float(runs[d][1]["lambda"]) for d in (device, "cpu")]
        costs = [float(runs[d][1]["final_cost"]) for d in (device, "cpu")]
        log(f"    {solver}: max |dT| {dx:.3g} (tolerance {CPU_TOL}); final lambda card / CPU "
            f"{lams}; final cost {costs}")
        if lams[0] != lams[1]:
            for k in range(1, cfg.max_iterations + 1):
                lk = [float(pg.optimize(*pose_graph_problem(64, solver, d, loop_every=16,
                                                            max_iterations=k))[1]["lambda"])
                      for d in (device, "cpu")]
                if lk[0] != lk[1]:
                    log(f"    the accept sequences part at LM iteration {k}: lambda {lk}")
                    break
            fail(f"pose graph {solver}: the card and the CPU accepted different steps")
        if dx > CPU_TOL:
            fail(f"pose graph {solver}: the card and the CPU disagree")
        out[solver] = dx
    return out


def loop_cfg(C):
    """tests/test_graph_pipeline.py::_cfg's loop gates and score_threshold on
    ``C.PipelineConfig`` with the graph on (a 5 m circle is 31.4 m long: the
    default 30 m of accumulated distance would leave no candidate)."""
    return C.PipelineConfig(
        enable_graph=True, scan_match=C.ScanMatchConfig(score_threshold=LOOP_SCORE),
        loop=C.LoopConfig(distance_thresh=3.0, estimated_distance_thresh=9.0,
                          accum_distance_thresh=12.0, min_loop_interval=2.0))


class GraphProbe:
    """Counts what the pose-graph backend of ``pipe`` does: the kernels'
    launches and merges inside ``detect_and_optimize``, the wall ms of each
    ``optimize`` (synchronized), the score and success of each loop's fine
    match (``scan_match_local``), and each map solve's score and frame
    features (``mapping_step``); the two are patched for the drive only."""

    def __init__(self, pipe):
        from cooper_mapper_torch.models import graph as graph_mod
        from cooper_mapper_torch.models import laser_mapping

        self.launches = dict.fromkeys(read_launches(), 0)
        self.merges = dict.fromkeys(read_merges(), 0)
        self.optimize_ms, self.fine, self.solves = [], [], []
        self._graph_mod, self._mapping = graph_mod, laser_mapping
        self._local, self._step = graph_mod.sm.scan_match_local, laser_mapping.mapping_step
        g = pipe.graph
        detect, optimize = g.detect_and_optimize, g.optimize

        def counted():
            l0, m0 = read_launches(), read_merges()
            loop = detect()
            for k, v in read_launches().items():
                self.launches[k] += v - l0[k]
            for k, v in read_merges().items():
                self.merges[k] += v - m0[k]
            return loop

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            diag = optimize()
            torch.cuda.synchronize()
            self.optimize_ms.append((time.perf_counter() - t0) * 1e3)
            return diag

        def fine(*args, **kw):
            res = self._local(*args, **kw)
            self.fine.append((float(res.score), bool(res.success)))
            return res

        def step(*args, **kw):
            out = self._step(*args, **kw)
            mo = out[2]
            self.solves.append((float(mo.result.score),
                                int(mo.corner_ds.mask.sum()) + int(mo.surf_ds.mask.sum())))
            return out

        self._g = g
        g.detect_and_optimize, g.optimize = counted, timed
        graph_mod.sm.scan_match_local = fine
        laser_mapping.mapping_step = step

    def close(self):
        self._graph_mod.sm.scan_match_local = self._local
        self._mapping.mapping_step = self._step
        del self._g.detect_and_optimize, self._g.optimize


def graph_drive(cfg, sweeps, device):
    """SlamPipeline(cfg, "mapping") over the sweeps with a GraphProbe.
    Returns (pipe, results, ms per sweep from sweep 3 on, probe)."""
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    pipe = SlamPipeline(cfg, "mapping", device=device)
    probe = GraphProbe(pipe)
    results, ms = [], []
    try:
        for i, sw in enumerate(sweeps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(pipe.process(sw))
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        probe.close()
    return pipe, results, ms, probe


def graph_pipeline_phase(device):
    """SlamPipeline(enable_graph=True) over the loop drive at full width, the
    default PipelineConfig but for tests/test_graph_pipeline.py::_cfg's loop
    gates and score_threshold: TestGraphInTheLoop's gates."""
    from cooper_mapper_torch import config as C
    from cooper_mapper_torch.io import evaluation, sim

    log(f"[20] SlamPipeline(enable_graph=True) over the loop drive: {LOOP_SWEEPS} sweeps of "
        f"{RINGS}x{WIDTH}, a 5 m circle closing after 48 sweeps, noise {LOOP_NOISE} m "
        f"(torch.Generator seed {LOOP_SEED}); PipelineConfig() with LoopConfig(3.0, 9.0, 12.0, "
        f"2.0) and score_threshold {LOOP_SCORE}")
    sweeps, truth = sim.loop_drive(LOOP_SWEEPS, WIDTH, LOOP_NOISE, LOOP_SEED, RINGS, device=device)
    cfg = loop_cfg(C)
    pipe, results, ms, probe = graph_drive(cfg, sweeps, device)
    default = C.ScanMatchConfig().score_threshold
    scores = [sc for sc, _ in probe.solves[1:]]    # the first solve meets an empty map
    feats = [n for _, n in probe.solves]
    log(f"    map solves {len(probe.solves)}: the first against a non-empty map scores "
        f"{scores[0]:.1f}, then {min(scores):.1f}-{max(scores):.1f} (median "
        f"{float(np.median(scores)):.1f}); the frames carry {min(feats)}-{max(feats)} features "
        f"after the voxel filter, so {sum(sc >= default for sc in scores)} solves reach "
        f"the default score_threshold {default}")
    log(f"    loops {[(lp.key_new, lp.key_old) for lp in pipe.graph.loops]}; fine-match "
        f"(score, success) {[(round(sc, 1), ok) for sc, ok in probe.fine]}")
    g = pipe.graph
    gt_rel = np.stack([np.linalg.inv(truth[0]) @ t for t in truth])
    period = cfg.registration.scan_period
    kf_gt = gt_rel[[int(round(kf.stamp / period)) for kf in g.keyframes]][:, :3, 3]
    ate_map = evaluation.ate(np.stack([kf.odom for kf in g.keyframes])[:, :3, 3], kf_gt).rmse
    ate_graph = evaluation.ate(g.estimates()[:, :3, 3], kf_gt).rmse
    corrected = pipe.corrected_trajectory()
    end_merged = float(np.linalg.norm(results[-1].merged_pose[:3, 3] - gt_rel[-1][:3, 3]))
    end_graph = float(np.linalg.norm(corrected[-1][:3, 3] - gt_rel[-1][:3, 3]))
    st = pipe.stats()
    calls = pipe.timer.calls["graph"]
    log(f"    stats {st}; keyframes {len(g.keyframes)}, edges {g.n_edges}; keyframe ATE graph "
        f"{ate_graph:.4f} m vs mapping {ate_map:.4f} m (< {GRAPH_ATE_MAX}); end pose error "
        f"graph {end_graph:.4f} vs merged {end_merged:.4f} m (+ {END_SLACK}); T_odom2graph - I "
        f"{float(np.linalg.norm(g.T_odom2graph - np.eye(4))):.4g}")
    log(f"    graph stage: {calls} calls, {pipe.timer.total_s['graph'] / max(calls, 1) * 1e3:.2f} "
        f"ms per call; optimize {len(probe.optimize_ms)} calls, ms "
        f"{[round(x, 1) for x in probe.optimize_ms]}; launches inside the graph stage "
        f"{probe.launches}, merges {probe.merges}; ms per sweep {ms_stat(ms)}")
    log("    StageTimer report:\n"
        + "\n".join("      " + ln for ln in pipe.timer.report().split("\n")))
    if not g.loops or not any(r.loop_closed for r in results):
        fail("the loop drive closed no loop")
    if not g.loops[0].key_new - g.loops[0].key_old > 8:
        fail(f"the first loop {g.loops[0]} does not join the circle's end to its start")
    if not (ate_graph < ate_map and ate_graph < GRAPH_ATE_MAX):
        fail("the graph did not cut the keyframe ATE")
    if not all(r.graph_pose is not None for r in results[1:]):
        fail("a result after the first carries no graph pose")
    if not (corrected.shape[0] == len(pipe.trajectory)
            and np.linalg.norm(g.T_odom2graph - np.eye(4)) > 1e-6):
        fail("corrected_trajectory does not apply the graph correction")
    if not end_graph < end_merged + END_SLACK:
        fail("the graph-corrected end pose lost more than the slack")
    if not {"keyframes", "loop_closures"} <= set(st):
        fail("stats() lacks the graph counters")
    if not (probe.launches["nn1"] > 0 and probe.launches["knn"] > 0):
        fail("the loop closure ran no nn1 or k-NN kernel")
    return pipe, dict(sweeps=sweeps, truth=gt_rel, cfg=cfg, ms=ms,
                      launches=probe.launches, merges=probe.merges,
                      optimize_ms=probe.optimize_ms, ate=(ate_graph, ate_map),
                      stage_ms=pipe.timer.total_s["graph"] / max(calls, 1) * 1e3)


def loop_stack(pipe, n_stack=6):
    """The loop matcher's surf inputs at the drive's first loop: the new
    keyframe, the stack of ``n_stack`` keyframes' surf clouds from the old
    one on in the old one's frame, and the guess, as ``LoopDetector.match``
    forms them from the current estimates."""
    from cooper_mapper_torch.models import graph as graph_mod

    g = pipe.graph
    lp = g.loops[0]
    est = g.estimates()
    cands = list(range(lp.key_old, min(lp.key_old + n_stack, lp.key_new)))
    mat = lambda T: torch.from_numpy(np.asarray(T, np.float32)).to(pipe.device)
    T_anchor_inv = np.linalg.inv(est[lp.key_old])
    ref_surf = graph_mod._concat_all([
        graph_mod._transform_cloud(g.keyframes[i].surf, mat(T_anchor_inv @ est[i]))
        for i in cands])
    return g.keyframes[lp.key_new], ref_surf, mat(T_anchor_inv @ est[lp.key_new]), cands


def icp_phase(pipe, device):
    """ICP on the card against the CPU on the drive's loop inputs; nn1 and
    the k-NN against their plain versions, bit for bit, at the loop's shapes
    (the ICP search of the keyframe's surf slots against the 6-keyframe
    stack; the fine match's 5-NN of the voxel-filtered surf against the
    voxel-filtered stack), with their plans and times."""
    from cooper_mapper_torch.build import library
    from cooper_mapper_torch.config import ScanMatchConfig
    from cooper_mapper_torch.ops import icp, knn, races
    from cooper_mapper_torch.ops.voxel import voxel_downsample
    from cooper_mapper_torch.utils import se3

    kf, ref_surf, T_guess, cands = loop_stack(pipe)
    log(f"[21] ICP and the loop's search shapes: keyframe surf {tuple(kf.surf.xyz.shape)} "
        f"({int(kf.surf.mask.sum())} valid) vs the stack of keyframes {cands} "
        f"{tuple(ref_surf.xyz.shape)} ({int(ref_surf.mask.sum())} valid)")
    T, rmse, n = icp.icp(kf.surf, ref_surf, T_guess, max_iterations=8, max_corr_dist=2.0)
    Tc, rmse_c, n_c = icp.icp(to_cpu(kf.surf), to_cpu(ref_surf), T_guess.cpu(),
                              max_iterations=8, max_corr_dist=2.0)
    dT = float((T.cpu() - Tc).abs().max())
    log(f"    icp card vs CPU: max |dT| {dT:.3g} (tolerance 1e-4), inliers {int(n)} / "
        f"{int(n_c)}, rmse {float(rmse):.5f} / {float(rmse_c):.5f}")
    if not (dT <= 1e-4 and int(n) == int(n_c)):
        fail("ICP on the card and the CPU disagree")
    n_sm = races.sm_count(device)
    q = se3.apply(T_guess, kf.surf.xyz)[None].contiguous()
    M = ref_surf.xyz.shape[0]
    S, L = races._split_plan(1, q.shape[1], M, n_sm, library().cooper_nn1_block_queries())
    m0 = read_merges()["nn1"]
    ik, dk = races.nn1(q, ref_surf.xyz, ref_surf.mask)
    merges = read_merges()["nn1"] - m0
    ip, dp = races.nn1_plain(q, ref_surf.xyz, ref_surf.mask)
    torch.cuda.synchronize()
    same = torch.equal(ik, ip) and torch.equal(dk, dp)
    log(f"    nn1 at the ICP shape 1x{q.shape[1]} vs {M}: split S={S} chunks of L={L} on "
        f"{n_sm} SMs, merges {merges}; bit-identical to nn1_plain {same}")
    if not same:
        fail("nn1 at the ICP shape disagrees with nn1_plain")
    log(f"    times ({RACE_TIMES})")
    nn1_row = dict(race_times("nn1", q, ref_surf, float((dk - dp).abs().max())), plan=[S, L],
                   merges=merges, where="ICP of the loop closure")
    nn1_row["device_ms"] = device_ms(lambda: races.nn1(q, ref_surf.xyz, ref_surf.mask),
                                     ("nn1_kernel", "merge_min"))[0]
    log(f"    nn1 at the ICP shape: device {fmt_ms(nn1_row['device_ms'])} ms per call (the kernel "
        "and its merge)")
    leaf = ScanMatchConfig().local_surf_leaf
    surf_ds, ref_ds = voxel_downsample(kf.surf, leaf), voxel_downsample(ref_surf, leaf)
    qk = se3.apply(T.to(device), surf_ds.xyz)[None].contiguous()
    ik, dk = knn.knn(qk, ref_ds.xyz, ref_ds.mask, KNN_K)
    ip, dp = knn.knn_plain(qk, ref_ds.xyz, ref_ds.mask, KNN_K)
    torch.cuda.synchronize()
    same = torch.equal(ik, ip) and torch.equal(dk, dp)
    Sk, Lk = knn._split_plan(1, qk.shape[1], ref_ds.xyz.shape[0], n_sm, knn_block_queries(KNN_K))
    log(f"    knn at the fine match's shape (voxel-filtered, leaf {leaf} m) 1x{qk.shape[1]} "
        f"({int(surf_ds.mask.sum())} valid) vs {ref_ds.xyz.shape[0]} ({int(ref_ds.mask.sum())} "
        f"valid): split S={Sk} chunks of L={Lk}; bit-identical to knn_plain {same}")
    if not same:
        fail("knn at the fine match's shape disagrees with knn_plain")
    knn_row = dict(knn_times("loop fine match", qk, ref_ds, float((dk - dp).abs().max()),
                             device_names=("knn_kernel", "merge_first_k")),
                   plan=[Sk, Lk], where="the loop closure's fine match")
    return dict(icp_dT=dT, nn1=nn1_row, knn=knn_row)


def graph_save_phase(pipe, drive, device):
    """GraphSlam.save on the card into a temporary directory: after.g2o
    holds the estimates within 1e-5 and the edges' information exactly; the
    saved map, loaded in "localization" mode and seeded at the graph pose
    four sweeps before the end, localizes the drive's last sweep within
    SAVE_LOC_TOL of the simulator's pose."""
    import tempfile

    from cooper_mapper_torch.io import map_io
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    g, cfg = pipe.graph, drive["cfg"]
    log("[22] GraphSlam.save on the card (.g2o before / after, trajectory PCDs, the rebuilt "
        "map), then load_g2o and load_feature_map in localization mode")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        g.save(d, map_cfg=cfg.feature_map)
        save_s = time.perf_counter() - t0
        poses, edges = map_io.load_g2o(os.path.join(d, "after.g2o"))
        dpose = float(np.abs(poses - g.estimates()).max())
        info_same = all(np.array_equal(a[3], b[3]) and (a[0], a[1]) == (b[0], b[1])
                        for a, b in zip(edges, g.edges_list())) and len(edges) == g.n_edges
        n_cubes = len(os.listdir(os.path.join(d, "map"))) - 1
        t0 = time.perf_counter()
        loaded = map_io.load_feature_map(os.path.join(d, "map"), cfg.feature_map, device=device)
        load_s = time.perf_counter() - t0
    k0 = len(drive["sweeps"]) - 4
    loc_cfg = dataclasses.replace(cfg, enable_graph=False)
    loc = SlamPipeline(loc_cfg, "localization", map_state=loaded,
                       initial_pose=pipe.corrected_trajectory()[k0], device=device)
    res = [loc.process(sw) for sw in drive["sweeps"][k0:]]
    err = float(np.linalg.norm(res[-1].merged_pose[:3, 3] - drive["truth"][-1][:3, 3]))
    log(f"    saved in {save_s:.2f} s ({n_cubes} cube files); after.g2o vs estimates max "
        f"{dpose:.3g} (tolerance 1e-5); edges {len(edges)}, information equal {info_same}; "
        f"loaded in {load_s:.2f} s; localization from sweep {k0} on the loaded map: "
        f"{loc.stats()}, last sweep {err:.4f} m from the simulator (< {SAVE_LOC_TOL})")
    if not (dpose <= 1e-5 and info_same):
        fail("the saved g2o does not hold the graph")
    if not err < SAVE_LOC_TOL:
        fail("the saved map does not localize the drive's last sweep")
    return dict(save_s=save_s, loc_err=err)


def graph_card_vs_cpu_phase(device):
    """The graph pipeline at phase 17's reduced configuration (tests/
    test_pipeline.py's _small_cfg with dedup after every map solve) with
    tests/test_torch_graph_pipeline.py's small loop gates and a 64-node
    graph, on the card and the CPU, on the same sweeps (7 of ``_simulate``,
    simulated on the CPU): the same keyframe and loop flags and loops, graph
    estimates and graph poses within CPU_TOL.  Dedup runs after every map
    solve: at the default dedup_stride of 4 a map solve's match fraction
    sits on the 0.4 gate (0.39836 on the card, 0.4 on the CPU), so rounding
    may flip it between the devices."""
    from cooper_mapper_torch import config as C
    from cooper_mapper_torch.models import laser_mapping
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.ops.features import Sweep

    log("[23] SlamPipeline(enable_graph=True) card vs CPU at phase 17's reduced configuration "
        "(_small_cfg, dedup_stride=1) with loop gates 1.0 / 0.5 / 3.0 / 9.0 and 64 nodes, "
        "7 sweeps")
    sweeps_cpu = simulate_reduced("cpu", n=7)
    mapping_step = laser_mapping.mapping_step
    solves = []

    def recorded(*args, **kw):
        out = mapping_step(*args, **kw)
        r = out[2].result
        solves.append((round(float(r.score), 2), round(float(r.match_fraction), 5),
                       bool(r.success)))
        return out

    cfg = reduced_pipeline_cfg(
        C, enable_graph=True, pose_graph=C.PoseGraphConfig(max_nodes=64, max_edges=128),
        loop=C.LoopConfig(distance_thresh=3.0, estimated_distance_thresh=9.0,
                          accum_distance_thresh=1.0, min_loop_interval=0.5))
    runs = {}
    for dev in (device, "cpu"):
        sweeps = [Sweep(s.xyz.to(dev), s.mask.to(dev), s.rel_time.to(dev)) for s in sweeps_cpu]
        pipe = SlamPipeline(cfg, "mapping", device=dev)
        solves.clear()
        laser_mapping.mapping_step = recorded
        try:
            results = [pipe.process(s) for s in sweeps]
        finally:
            laser_mapping.mapping_step = mapping_step
        flags = [(r.new_keyframe, r.loop_closed) for r in results]
        log(f"    {dev}: per sweep (new_keyframe, loop_closed) {flags}; map solves (score, "
            f"match fraction, success) {solves}; loops "
            f"{[(lp.key_new, lp.key_old) for lp in pipe.graph.loops]}")
        runs[dev] = (pipe, results, flags)
    (gp, gr, gflags), (cp, cr, cflags) = runs[device], runs["cpu"]
    loops = [(lp.key_new, lp.key_old) for lp in gp.graph.loops]
    same = gflags == cflags and loops == [(lp.key_new, lp.key_old) for lp in cp.graph.loops]
    if not cp.graph.loops:
        fail("the reduced graph drive closed no loop on the CPU")
    if not same:
        fail("the graph pipeline on the card and on the CPU made other keyframes or loops")
    d_est = float(np.abs(gp.graph.estimates() - cp.graph.estimates()).max())
    d_pose = max(float(np.abs(a.graph_pose - b.graph_pose).max()) for a, b in zip(gr[1:], cr[1:]))
    log(f"    keyframe and loop flags and loops {loops} equal; max |d estimates| {d_est:.3g}, "
        f"max |d graph_pose| {d_pose:.3g} (tolerance {CPU_TOL})")
    if not (d_est <= CPU_TOL and d_pose <= CPU_TOL):
        fail("the graph pipeline on the card and on the CPU disagree")
    return max(d_est, d_pose)


# The parity modes: the reference's iteration dynamics, held to the float64
# transcription of the C++ solves in tests/ref_oracle.py (numpy only)
GOLDEN_KS = (1, 2, 5, 7, 10, 25)   # tests/test_parity_golden.py::TestGoldenTrace
ODO_GOLDEN_TOL = 3e-4               # its tolerance
SM_GOLDEN_TOL = 2e-3                # TestScanMatchGolden's
SM_GOLDEN_KS = (1, 3, 10)


def load_oracle():
    """tests/ref_oracle.py, loaded by path (it imports numpy only)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "ref_oracle.py")
    spec = importlib.util.spec_from_file_location("ref_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # its dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def add_counts(tally, launches, merges):
    """Add one run's launches and merges to ``tally`` (name -> dict)."""
    for k, n in launches.items():
        row = tally.setdefault(k, {"launches": 0, "merges": 0})
        row["launches"] += n
        row["merges"] += merges.get(k, 0)


def counted(tally, fn):
    """``fn()`` with every launch counter at 0 first; its launches and merges
    are added to ``tally`` and returned beside its result."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches, merges = read_launches(), read_merges()
    add_counts(tally, launches, merges)
    return out, launches, merges


def ring_major(cl):
    """(xyz, ring, rel_time) numpy of a cloud's valid points, ring-major
    sorted (tests/test_parity_golden.py::_ring_major_dense): the layout the
    reference's index walks assume."""
    m = cl.mask.cpu().numpy()
    xyz, ring, rel = (t.cpu().numpy()[m] for t in (cl.xyz, cl.ring, cl.rel_time))
    order = np.lexsort((rel, ring))
    return xyz[order], ring[order], rel[order]


def golden_odometry_phase(clouds, tally, device):
    """The odometry parity solve against the oracle's trace on the bench
    pair, on both routes."""
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry
    from cooper_mapper_torch.utils import cloud

    oracle = load_oracle()
    dense = [ring_major(c) for c in clouds]
    log(f"[24] golden odometry trace: the bench pair of phase 4 (sharp, flat, less_sharp, "
        f"less_flat: {[len(d[0]) for d in dense]} points, ring-major) against "
        f"tests/ref_oracle.odometry_scan_match in float64")
    f64 = lambda a: a.astype(np.float64)
    (sx, _, s_rel), (fx, _, f_rel), (cx, c_ring, _), (rx, r_ring, _) = dense
    t0 = time.perf_counter()
    trace = oracle.odometry_scan_match(f64(sx), f64(s_rel), f64(fx), f64(f_rel), f64(cx), c_ring,
                                       f64(rx), r_ring)
    oracle_s = time.perf_counter() - t0
    log(f"    oracle: {oracle_s:.2f} s for {len(trace)} iterations; iteration 0 degenerate "
        f"{trace[0].is_degenerate}, rows {trace[0].n_selected}; final x {trace[-1].x.round(5).tolist()}")
    port = [cloud.from_points(d[0], capacity=c.xyz.shape[0], ring=d[1], rel_time=d[2],
                              device=device) for d, c in zip(dense, clouds)]
    errs = {}
    try:
        for route in ("split", "fused"):
            os.environ["COOPER_PALLAS_FUSED"] = "1" if route == "fused" else "0"

            def solves():
                return [odometry.odometry_solve(*port, torch.zeros(6, device=device),
                                                OdometryConfig(max_iterations=k),
                                                parity_mode=True)[0] for k in GOLDEN_KS]
            xs, launches, _ = counted(tally, solves)
            err = [float(np.abs(x.double().cpu().numpy() - trace[min(k, len(trace)) - 1].x).max())
                   for k, x in zip(GOLDEN_KS, xs)]
            errs[route] = max(err)
            log(f"    {route} route: max |x - oracle| after k = {list(GOLDEN_KS)} iterations "
                f"{[f'{e:.3g}' for e in err]} (tolerance {ODO_GOLDEN_TOL}); launches {launches}")
            used = launches["fused_races"] if route == "fused" else launches["nn1"]
            if not (used > 0 and max(err) <= ODO_GOLDEN_TOL):
                fail(f"the parity odometry trace on the {route} route left the oracle's")
    finally:
        os.environ["COOPER_PALLAS_FUSED"] = "0"
    return dict(errs, oracle_s=oracle_s)


def solves_per_s(fns, B, rounds=4):
    """Steady-state solves/s (best, median) of each of ``fns`` (name ->
    callable), timed in turns, the order alternating per round."""
    names = list(fns)
    dts = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[n]()
            torch.cuda.synchronize()
            dts[n].append(time.perf_counter() - t0)
    return {n: (B / min(d), B / float(np.median(d))) for n, d in dts.items()}


def parity_solve_phase(sharp, flat, ref_c, ref_s, x0, motion, tally):
    """batch_odometry_solve(parity_mode=True) at B = 512 on the bench problem."""
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry

    cfg = OdometryConfig()
    B = x0.shape[0]
    log(f"[25] odometry parity mode: batch_odometry_solve(parity_mode=True), B={B}, the bench "
        f"problem, default OdometryConfig")
    solve = lambda x, parity: odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x, cfg,
                                                            parity_mode=parity)
    (x, st), launches, merges = counted(tally, lambda: solve(x0, True))
    n_blocks = -(-cfg.max_iterations // cfg.refresh_every)
    expected = {"nn1": 2 * n_blocks, "nn1_masked": n_blocks, "bc_races": n_blocks,
                "fused_races": 0, "merge_min": 0, "knn": 0}
    log(f"    launches {launches} (expected {expected}); split with a merge {merges}")
    if launches != expected:
        fail("the parity odometry path did not launch every race kernel as expected")
    if not torch.isfinite(x).all():
        fail("non-finite parity lanes")
    te, re_ = lane_errors(x, motion)
    log(f"    all {B} lanes finite; degenerate {int(st.is_degenerate.sum())}, converged "
        f"{int(st.converged.sum())}; vs ground truth (information: the -0.05 under-relaxation "
        f"leaves a partial step after 25 iterations) translation max {float(te.max()):.4f} m, "
        f"rotation max {float(re_.max()):.4f} rad")
    x_cpu, _ = odometry.batch_odometry_solve(
        to_cpu(sharp, CPU_LANES), to_cpu(flat, CPU_LANES), to_cpu(ref_c), to_cpu(ref_s),
        x0[:CPU_LANES].cpu(), cfg, parity_mode=True)
    dx = float((x[:CPU_LANES].cpu() - x_cpu).abs().max())
    log(f"    lanes 0..{CPU_LANES - 1} vs the CPU plain-version run: max |dx| {dx:.3g} "
        f"(tolerance {CPU_TOL})")
    if not dx <= CPU_TOL:
        fail("card and CPU parity solves disagree")
    rng = np.random.RandomState(1)
    xr = torch.from_numpy((0.02 * rng.randn(B, 6)).astype(np.float32)).to(x0.device)
    sps = solves_per_s({"parity": lambda: solve(xr, True), "native": lambda: solve(xr, False)}, B)
    log("    steady state, in turns: " + "; ".join(
        f"{n} {v[0]:.1f} solves/s best, {v[1]:.1f} median" for n, v in sps.items()))
    return sps


def parity_drive_phase(cfg, sweeps, truth, tally, device):
    """models/laser_odometry over the single-stream sweeps in parity mode."""
    from cooper_mapper_torch.models import laser_odometry
    from cooper_mapper_torch.ops import features

    reg = cfg.registration
    log(f"[26] laser_odometry.step(parity_mode=True) over phase 9's {len(sweeps)} sweeps, "
        f"default PipelineConfig's registration and odometry")
    race = {"nn1": 10, "nn1_masked": 5, "bc_races": 5}
    race_merges = split_race_merges(cfg, race["bc_races"], device)
    feats = [features.extract_features(sw, reg) for sw in sweeps]
    st = laser_odometry.init_step(laser_odometry.create(reg.max_less_sharp, reg.max_less_flat,
                                                        device), feats[0], cfg.odometry,
                                  parity_mode=True)
    poses, ms = [], []
    for i, fc in enumerate(feats[1:], 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (st, out), launches, merges = counted(
            tally, lambda: laser_odometry.step(st, fc, cfg.odometry, parity_mode=True))
        ms.append((time.perf_counter() - t0) * 1e3)
        poses.append(out.T_sum.cpu().numpy())
        got = {k: launches[k] for k in race}
        got_m = {k: merges[k] for k in race}
        if got != race or got_m != race_merges or launches["merge_min"] != sum(race_merges.values()):
            fail(f"parity drive: sweep {i} launched {launches} with merges {merges}, expected "
                 f"{race} and {race_merges}")
    poses = np.stack(poses)
    gt = np.linalg.inv(truth[1]) @ truth[-1]
    err = float(np.linalg.norm(poses[-1][:3, 3] - gt[:3, 3]))
    log(f"    per sweep {race} race launches, merges {race_merges}; ms per odometry step "
        f"{ms_stat(ms[2:])}; final position {poses[-1][:3, 3].round(4).tolist()} vs the "
        f"simulator's {gt[:3, 3].round(4).tolist()}: error {err:.4f} m (information)")
    if not np.isfinite(poses).all():
        fail("the parity drive gave a non-finite pose")
    return dict(err=err, ms=ms)


def map_scene(device):
    """tests/test_parity_golden.py::map_scene with the port's simulator and
    extractor at its 16 x 512: sweep 0's voxel-filtered features at ground
    truth, jittered 1 cm, form the map; sweep 1's are solved from a guess
    perturbed off the true pose."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import features
    from cooper_mapper_torch.ops.voxel import voxel_downsample
    from cooper_mapper_torch.utils import twist

    world = sim.make_room_world(size=(24.0, 4.0, 30.0), n_pillars=6, seed=5, device=device)
    cfg = RegistrationConfig(n_rings=16, max_points_per_ring=512, max_sharp=128,
                             max_less_sharp=1024, max_flat=256, max_less_flat=4096)
    p0 = np.eye(4, dtype=np.float32)
    p0[1, 3] = 1.5
    step = np.eye(4, dtype=np.float32)
    step[2, 3] = 0.3
    c, s = np.cos(0.02), np.sin(0.02)
    step[0, 0], step[0, 2], step[2, 0], step[2, 2] = c, s, -s, c
    p1 = p0 @ step
    T = lambda p: torch.from_numpy(p).to(device)
    fc0, fc1 = (features.extract_features(sim.scan_sweep(world, T(p), T(p), 16, 512), cfg)
                for p in (p0, p1))

    def valid(cl, leaf):
        d = voxel_downsample(cl, leaf)
        return d.xyz[d.mask].cpu().numpy()

    world_frame = lambda xyz: (p0[:3, :3] @ xyz.T).T + p0[:3, 3]
    rng = np.random.RandomState(7)
    ref_c = world_frame(valid(fc0.less_sharp, 0.2))
    ref_s = world_frame(valid(fc0.less_flat, 0.4))
    ref_c = ref_c + 0.01 * rng.randn(*ref_c.shape).astype(np.float32)
    ref_s = ref_s + 0.01 * rng.randn(*ref_s.shape).astype(np.float32)
    x_true = twist.from_mat(T(p1)).double().cpu().numpy()
    x0 = x_true + np.array([0.01, -0.008, 0.012, 0.05, -0.04, 0.06])
    return dict(ref_c=ref_c, ref_s=ref_s, q_c=valid(fc1.less_sharp, 0.2),
                q_s=valid(fc1.flat, 0.4), x0=x0, x_true=x_true)


def scan_match_parity_phase(corner, surf, ref_c, ref_s, x0, tally, device):
    """batch_scan_match(parity_mode=True) at B = 64 on the bench problem, then
    the golden map scene's two variants against the oracle."""
    from cooper_mapper_torch.config import ScanMatchConfig
    from cooper_mapper_torch.ops import scan_match as sm
    from cooper_mapper_torch.utils import cloud

    cfg = ScanMatchConfig()
    B = x0.shape[0]
    log(f"[27] scan-to-map parity mode: batch_scan_match(parity_mode=True), B={B}, the bench "
        f"problem of phase 6, default ScanMatchConfig")
    corner_b, surf_b = tile(corner, B), tile(surf, B)
    res, launches, merges = counted(
        tally, lambda: sm.batch_scan_match(corner_b, surf_b, ref_c, ref_s, x0, cfg,
                                           parity_mode=True))
    expected = {"nn1": 0, "nn1_masked": 0, "bc_races": 0, "fused_races": 0, "merge_min": 0,
                "knn": 2 * (cfg.max_iterations + 1)}
    log(f"    launches {launches} (expected {expected}); split with a merge {merges}")
    if launches != expected:
        fail("the scan-to-map parity path did not launch the k-NN kernel as expected")
    if not torch.isfinite(res.x).all():
        fail("non-finite scan-to-map parity lanes")
    res_cpu = sm.batch_scan_match(to_cpu(corner_b, CPU_LANES), to_cpu(surf_b, CPU_LANES),
                                  to_cpu(ref_c), to_cpu(ref_s), x0[:CPU_LANES].cpu(), cfg,
                                  parity_mode=True)
    dx = float((res.x[:CPU_LANES].cpu() - res_cpu.x).abs().max())
    log(f"    all {B} lanes finite; success {int(res.success.sum())}, degenerate "
        f"{int(res.is_degenerate.sum())}; lanes 0..{CPU_LANES - 1} vs the CPU: max |dx| {dx:.3g} "
        f"(tolerance {CPU_TOL})")
    if not dx <= CPU_TOL:
        fail("card and CPU scan-to-map parity solves disagree")

    oracle = load_oracle()
    scene = map_scene(device)
    f64 = lambda a: a.astype(np.float64)
    mk = lambda a, cap: cloud.from_points(a, capacity=cap, device=device)
    args = (mk(scene["q_c"], 256), mk(scene["q_s"], 512), mk(scene["ref_c"], 1024),
            mk(scene["ref_s"], 4096), torch.from_numpy(scene["x0"].astype(np.float32)).to(device))
    log(f"    map scene (tests/test_parity_golden.py::map_scene, the port's simulator and "
        f"extractor at 16 x 512): map {len(scene['ref_c'])} / {len(scene['ref_s'])}, frame "
        f"{len(scene['q_c'])} / {len(scene['q_s'])} points")
    out = {}
    for thr in (10.0, 100.0):
        cfg_g = ScanMatchConfig(score_threshold=50.0, eig_threshold=thr)
        card_V = []
        eigh = torch.linalg.eigh

        def recording_eigh(A):
            w, V = eigh(A)
            card_V.append(V[0].double().cpu().numpy())
            return w, V

        def port(k):
            torch.linalg.eigh = recording_eigh
            try:
                return sm.scan_match(*args, dataclasses.replace(cfg_g, max_iterations=k),
                                     parity_mode=True)
            finally:
                torch.linalg.eigh = eigh
        xs, _, _ = counted(tally, lambda: [port(k).x.double().cpu().numpy() for k in SM_GOLDEN_KS])
        run = lambda: oracle.scan_match_scan(f64(scene["ref_c"]), f64(scene["ref_s"]),
                                             f64(scene["q_c"]), f64(scene["q_s"]), scene["x0"],
                                             max_iterations=10, score_threshold=50.0,
                                             eig_threshold=thr)
        np_eigh, agree = np.linalg.eigh, []

        def card_signed_eigh(M):
            # the 6x6 projector eigh only: numpy's vectors, signed as the card's
            w, V = np_eigh(M)
            if M.shape == (6, 6):
                sign = np.sign((V * card_V[0]).sum(0))
                agree.append(sign > 0)
                V = V * sign
            return w, V
        golden = run()
        np.linalg.eigh = card_signed_eigh
        try:
            golden_card = run()
        finally:
            np.linalg.eigh = np_eigh
        errs = lambda g: [float(np.abs(x - g.trace[min(k, len(g.trace)) - 1].x).max())
                          for k, x in zip(SM_GOLDEN_KS, xs)]
        direct, signed = errs(golden), errs(golden_card)
        same_signs = bool(agree[0].all())
        degenerate = golden.trace[0].is_degenerate
        log(f"    eig_threshold {thr}: degenerate {degenerate}; the card's iteration-0 eigenvectors "
            f"agree in sign with numpy's per column {agree[0].tolist()}; max |x - oracle| at "
            f"k = {list(SM_GOLDEN_KS)}: {[f'{e:.3g}' for e in direct]}, against the oracle run "
            f"with the card's signs {[f'{e:.3g}' for e in signed]} (tolerance {SM_GOLDEN_TOL}); "
            f"oracle accepted {golden.accepted}")
        gate = direct if (same_signs or not degenerate) else signed
        if max(gate) > SM_GOLDEN_TOL:
            fail(f"the parity scan match at eig_threshold {thr} left the oracle's trace")
        out[thr] = dict(direct=max(direct), signed=max(signed), signs=agree[0].tolist(),
                        degenerate=degenerate)
    return dict(dx=dx, scenes=out)


def dewarp_passes_phase(quick_ate, device, n_sweeps=49):
    """README's Quick start figure eight with dewarp_passes=2, then the
    pipeline at _small_cfg with dewarp_passes=2 on the card and the CPU."""
    from cooper_mapper_torch import config as C
    from cooper_mapper_torch.io import evaluation, sim
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.ops.features import Sweep

    log("[28] dewarp_passes=2: README's Quick start figure eight (phase 16's drive), "
        "PipelineConfig(odometry=OdometryConfig(dewarp_passes=2)), mode 'mapping'")
    base = C.PipelineConfig()
    cfg = dataclasses.replace(base, odometry=dataclasses.replace(base.odometry, dewarp_passes=2))
    world = sim.make_room_world(seed=1, device=device)
    poses = sim.figure_eight_trajectory(n_sweeps + 1)
    sweeps = [sim.scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]))
              for i in range(n_sweeps)]
    pipe = SlamPipeline(cfg, mode="mapping", device=device)
    results, ms, launches, _ = drive_pipeline(pipe, sweeps, "dewarp_passes=2 Quick start")
    est, odo = np.stack(pipe.trajectory), np.stack(pipe.odom_trajectory)
    ate, ate_odo = evaluation.pipeline_ate(est, poses), evaluation.pipeline_ate(odo, poses)
    log(f"    per sweep twice phase 16's race launches (checked); ms per sweep {ms_stat(ms)}; "
        f"pipeline_ate rmse mapping {ate.rmse:.4f} m, odometry only {ate_odo.rmse:.4f} m, against "
        f"dewarp_passes=1 (phase 16) {quick_ate['ate']:.4f} / {quick_ate['ate_odo']:.4f} m")
    if not (np.isfinite(est).all() and np.isfinite(odo).all()):
        fail("the dewarp_passes=2 drive gave a non-finite pose")

    small = reduced_pipeline_cfg(C)
    small = dataclasses.replace(small, odometry=dataclasses.replace(small.odometry,
                                                                    dewarp_passes=2))
    sweeps_cpu = simulate_reduced("cpu")
    card = [Sweep(s.xyz.to(device), s.mask.to(device), s.rel_time.to(device)) for s in sweeps_cpu]
    merged = {}
    for dev, sw in ((device, card), ("cpu", sweeps_cpu)):
        pipe = SlamPipeline(small, "mapping", device=dev)
        res = drive_pipeline(pipe, sw, f"reduced dewarp_passes=2 {dev}", check_launches=dev != "cpu")
        merged[dev] = np.stack([r.merged_pose for r in res[0]])
    dx = float(np.abs(merged[device] - merged["cpu"]).max())
    log(f"    _small_cfg with dewarp_passes=2, mapping, _simulate(6) on the CPU: card vs CPU max "
        f"|dW| {dx:.3g} (tolerance {CPU_TOL})")
    if not dx <= CPU_TOL:
        fail("the dewarp_passes=2 pipeline on the card and on the CPU disagree")
    return dict(ate=ate.rmse, ate_odo=ate_odo.rmse, dx=dx, ms=ms)


def features_debug_phase(device):
    """extract_features_debug at 16 x 1024 on the card, against
    extract_features on the card and against the CPU on the same sweep."""
    from cooper_mapper_torch.config import RegistrationConfig
    from cooper_mapper_torch.io import sim
    from cooper_mapper_torch.ops import features as F

    log("[29] extract_features_debug on the bench sweep (16 x 1024, make_room_world(seed=42), "
        "simulated on the CPU), on the card and on the CPU")
    world = sim.make_room_world(seed=WORLD_SEED, device="cpu")
    p0 = torch.eye(4)
    p0[1, 3] = 1.5
    sw_cpu = sim.scan_sweep(world, p0, p0, RINGS, WIDTH)
    sw = F.Sweep(sw_cpu.xyz.to(device), sw_cpu.mask.to(device), sw_cpu.rel_time.to(device))
    cfg = RegistrationConfig(n_rings=RINGS, max_points_per_ring=WIDTH)
    fc, dbg = F.extract_features_debug(sw, cfg)
    plain = F.extract_features(sw, cfg)
    fields = ("xyz", "mask", "ring", "rel_time")
    same = all(torch.equal(getattr(getattr(fc, n), f), getattr(getattr(plain, n), f))
               for n in ("sharp", "less_sharp", "flat", "less_flat") for f in fields)
    counts = (int(dbg.sharp_picked.sum()), int(fc.sharp.mask.sum()), int(dbg.flat_picked.sum()),
              int(fc.flat.mask.sum()))
    enums = (set(dbg.status.unique().tolist()) <= {F.BLIND_BLOCK, F.NEAR_BLOCK, F.EDGE_BROKEN,
                                                    F.STATUS_NONE}
             and set(dbg.label.unique().tolist()) <= {F.MESSY, F.CLS_SURFACE_FLAT,
                                                      F.CLS_CORNER_SHARP, F.CLS_ONESIDE_FLAT}
             and int(dbg.region_id.min()) >= -1
             and int(dbg.region_id.max()) < cfg.n_feature_regions)
    log(f"    clouds bit-identical to extract_features' {same}; picked sharp / cloud "
        f"{counts[0]} / {counts[1]}, flat {counts[2]} / {counts[3]}; enums in their sets {enums}")
    if not (same and counts[0] == counts[1] and counts[2] == counts[3] and enums):
        fail("extract_features_debug on the card is inconsistent")
    _, dbg_cpu = F.extract_features_debug(sw_cpu, cfg)
    differ = {f: int((getattr(dbg, f).cpu() != getattr(dbg_cpu, f)).sum())
              for f in ("curvature", "status", "label", "region_id", "sharp_picked", "flat_picked")}
    rel = float(((dbg.curvature.cpu() - dbg_cpu.curvature).abs()
                 / dbg_cpu.curvature.abs().clamp(min=1e-30)).max())
    flips = (dbg.label.cpu() != dbg_cpu.label).any(-1)
    picks_elsewhere = any(bool(((getattr(dbg, f).cpu() != getattr(dbg_cpu, f)).any(-1)
                                & ~flips).any()) for f in ("sharp_picked", "flat_picked"))
    log(f"    card vs CPU, points that differ per field {differ} of {dbg.label.numel()}; curvature "
        f"max relative difference {rel:.3g} (tolerance 1e-5); status and region ids must be "
        f"equal, labels may differ on 0.1% of the points (an ulp of arccos / cos decides a "
        f"threshold), the picks only in rings of such a label: picks elsewhere {picks_elsewhere}")
    if (rel > 1e-5 or differ["status"] or differ["region_id"]
            or differ["label"] > 1e-3 * dbg.label.numel() or picks_elsewhere):
        fail("extract_features_debug on the card disagrees with the CPU")
    return differ


# The out-of-core map, the offline converter and the host I/O (phases 30-33).
# tests/test_long_run.py's corridor and bounds
CORRIDOR_OUT, CORRIDOR_BACK, CORRIDOR_STEP_M, CORRIDOR_RAMP = 60, 40, 0.5, 4
CORRIDOR_ATE, CORRIDOR_SUCCESS = 0.25, 0.55
TRANSPARENT_TOL = 1e-5                            # TestDynamicEqualsStatic
BAG_TOL = 0.3                                     # TestRosbag::test_bag_feeds_pipeline
# the converter: queries held to knn_plain, queries timed, the label gate
CONVERT_K, CONVERT_CHECKED, CONVERT_TIMED = 10, 4096, 1024
LABEL_MARGIN, LABEL_SHARE = 1e-4, 1e-3


def tally_drive(tally, launches):
    """Add a drive_pipeline run's launches (with their "merges") to ``tally``."""
    launches = dict(launches)
    add_counts(tally, launches, launches.pop("merges"))


def corridor_sweeps(device, n_out=CORRIDOR_OUT, n_back=CORRIDOR_BACK):
    """tests/test_long_run.py::_corridor_run at full width: out and back along
    the room's long axis, 0.5 m per sweep, the reversal ramped over 2 x 4
    sweeps.  Returns (sweeps, the n + 1 poses)."""
    from cooper_mapper_torch.io import sim

    world = sim.make_room_world(size=(30.0, 4.0, 40.0), n_pillars=8, seed=11, device=device)
    poses = [np.eye(4, dtype=np.float32)]
    poses[0][1, 3], poses[0][2, 3] = 1.5, -14.0
    for i in range(n_out + n_back):
        if n_out - CORRIDOR_RAMP <= i < n_out + CORRIDOR_RAMP:
            frac = (i - (n_out - CORRIDOR_RAMP)) / (2.0 * CORRIDOR_RAMP)
            v = CORRIDOR_STEP_M * float(np.cos(np.pi * frac))
        else:
            v = CORRIDOR_STEP_M if i < n_out else -CORRIDOR_STEP_M
        step = np.eye(4, dtype=np.float32)
        step[2, 3] = v
        poses.append(poses[-1] @ step)
    sweeps = [sim.scan_sweep(world, torch.from_numpy(poses[i]), torch.from_numpy(poses[i + 1]),
                             RINGS, WIDTH) for i in range(n_out + n_back)]
    return sweeps, np.stack(poses)


def corridor_cfg(directory, dynamic=True):
    """The default PipelineConfig but for tests/test_long_run.py::_cfg's map
    and matcher, mapping_stride and score_threshold."""
    from cooper_mapper_torch.config import (MapConfig, MatcherConfig, PipelineConfig,
                                            ScanMatchConfig)

    return PipelineConfig(
        scan_match=ScanMatchConfig(score_threshold=50.0),
        feature_map=MapConfig(n_cubes=(5, 3, 5), cube_size=8.0, corner_cube_capacity=768,
                              surf_cube_capacity=1536, surround_corner_capacity=6144,
                              surround_surf_capacity=12288, valid_distance=24.0,
                              margin_cubes=1),
        matcher=MatcherConfig(max_frame_corner=2048, max_frame_surf=4096, dynamic_mode=dynamic,
                              map_directory=directory, dedup_stride=1),
        mapping_stride=2)


def ms_brief(ms):
    return (f"{min(ms):.1f} / {float(np.median(ms)):.1f} / {float(np.mean(ms)):.1f} (best / "
            f"median / mean of {len(ms)})")


def stage_ms(timer, name):
    """(ms per call, steady ms per call: the first call left out) of a stage."""
    n, tot = timer.calls[name], timer.total_s[name]
    steady = (tot - timer.first_s[name]) / (n - 1) if n > 1 else tot
    return tot / max(n, 1) * 1e3, steady * 1e3


def corridor_phase(tally, device):
    """SlamPipeline with matcher.dynamic_mode over the corridor at full width:
    tests/test_long_run.py's gates, then bit-transparency against the static
    map and the two pagers."""
    import tempfile

    from cooper_mapper_torch.io import evaluation, native_pager
    from cooper_mapper_torch.models.pipeline import SlamPipeline

    t0 = time.perf_counter()
    log(f"[30] out-of-core map: SlamPipeline(mode='mapping') with matcher.dynamic_mode over "
        f"tests/test_long_run.py's corridor at {RINGS} x {WIDTH} ({CORRIDOR_OUT} sweeps out and "
        f"{CORRIDOR_BACK} back, {CORRIDOR_STEP_M} m per sweep), its _cfg map (5 x 3 x 5 cubes of "
        f"8 m, margin 1) and matcher, mapping_stride 2, score_threshold 50")
    sweeps, gt = corridor_sweeps(device)
    with tempfile.TemporaryDirectory() as d:
        pipe = SlamPipeline(corridor_cfg(d), "mapping", device=device)
        # the forward leg, then the return: the flushes of the forward leg are
        # read between the two
        results, ms, launches, _ = drive_pipeline(pipe, sweeps[:CORRIDOR_OUT], "corridor")
        tally_drive(tally, launches)
        flushed_out = pipe.dmap.n_flushed
        back, ms_back, launches, _ = drive_pipeline(pipe, sweeps[CORRIDOR_OUT:], "corridor",
                                                    start=CORRIDOR_OUT)
        tally_drive(tally, launches)
        results, ms = results + back, ms + ms_back
        pipe.save_map()
        files = sorted(os.listdir(d))
    dmap, fmc = pipe.dmap, pipe.cfg.feature_map
    est = np.stack([r.merged_pose for r in results])
    ate = evaluation.pipeline_ate(est, gt).rmse
    ran = [r.mapping_success for r in results if r.mapping_success is not None]
    late = float(np.mean(ran[len(ran) // 2:]))
    corner_max, surf_max = (int(cc.count.max()) for cc in (pipe.map_state.corner,
                                                            pipe.map_state.surf))
    n_pcd = sum(f.endswith(".pcd") for f in files)
    paging = stage_ms(pipe.timer, "paging")
    native = isinstance(dmap.pager, native_pager.CubePager)
    log(f"    stats {pipe.stats()}")
    log(f"    flushed {dmap.n_flushed} (>= 4; {flushed_out} on the way out), loaded {dmap.n_loaded} (>= 2), {len(dmap.on_disk)} "
        f"cubes on disk; save_map wrote index2.txt {'index2.txt' in files} and {n_pcd} .pcd "
        f"(>= 4); native pager {native}; fullest cubes corner {corner_max} / "
        f"{fmc.corner_cube_capacity}, surf {surf_max} / {fmc.surf_cube_capacity}; ATE rmse "
        f"{ate:.4f} m (< {CORRIDOR_ATE}); late-run success {late:.3f} (> {CORRIDOR_SUCCESS})")
    log(f"    paging stage {paging[0]:.2f} ms per call, {paging[1]:.2f} steady "
        f"({pipe.timer.calls['paging']} calls); ms per sweep {ms_brief(ms)}")
    log("    StageTimer report:\n" + "\n".join("      " + ln for ln in pipe.timer.report().split("\n")))
    if not native:
        fail("the dynamic map did not take the native pager")
    if dmap.n_flushed < 4 or dmap.n_loaded < 2 or "index2.txt" not in files or n_pcd < 4:
        fail("the corridor did not page cubes out and back in")
    if corner_max >= fmc.corner_cube_capacity or surf_max >= fmc.surf_cube_capacity:
        fail("a cube of the corridor's map reached its capacity")
    if not (np.isfinite(est).all() and ate < CORRIDOR_ATE and late > CORRIDOR_SUCCESS):
        fail("the corridor drive left tests/test_long_run.py's bounds")
    out = dict(ms=ms, paging=paging, ate=ate, late=late, flushed=dmap.n_flushed,
               loaded=dmap.n_loaded, files=n_pcd)
    del pipe

    # bit-transparency (TestDynamicEqualsStatic): over the forward leg, where
    # cubes leave the window and none comes back, a static map gives the
    # dynamic run's poses.  The whole leg, not the JAX test's 30 sweeps: the
    # first occupied cubes leave the window only after ~50 sweeps.
    with tempfile.TemporaryDirectory() as d:
        p = SlamPipeline(corridor_cfg(d, dynamic=False), "mapping", device=device)
        res, ms_static, launches, _ = drive_pipeline(p, sweeps[:CORRIDOR_OUT], "corridor, static")
        tally_drive(tally, launches)
    static = np.stack([r.merged_pose for r in res])
    dx = float(np.abs(est[:CORRIDOR_OUT] - static).max())
    ms_dynamic = ms[:CORRIDOR_OUT - 3]
    log(f"    forward {CORRIDOR_OUT} sweeps, static vs dynamic map: max |dpose| {dx:.3g} (<= "
        f"{TRANSPARENT_TOL}; the dynamic map flushed {flushed_out} cubes on that leg); ms per "
        f"sweep static {ms_brief(ms_static)}, dynamic {ms_brief(ms_dynamic)}")
    if not (dx <= TRANSPARENT_TOL and flushed_out > 0):
        fail("paging moved the poses of the forward leg, or flushed nothing there")
    out.update(transparent_dx=dx, static_ms=ms_static, dynamic_ms=ms_dynamic,
               flushed_out=flushed_out)
    out["pagers_equal"] = pagers_phase(device)
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 30: {out['seconds']:.1f} s")
    return out


def pagers_phase(device):
    """tests/test_io.py::TestDynamicMap::test_native_matches_python_paging
    on the card: the native and the numpy pager, out, further and back."""
    import tempfile

    from cooper_mapper_torch.config import MapConfig
    from cooper_mapper_torch.maps import dynamic_map
    from cooper_mapper_torch.utils import cloud

    cfg = MapConfig(n_cubes=(5, 3, 5), cube_size=10.0, corner_cube_capacity=256,
                    surf_cube_capacity=512, surround_corner_capacity=2048,
                    surround_surf_capacity=4096, valid_distance=25.0)
    pts = np.random.RandomState(3).uniform(-12, 12, (40, 3)).astype(np.float32)
    got = []
    with tempfile.TemporaryDirectory() as d:
        for native in (False, True):
            dmap = dynamic_map.DynamicFeatureMap.create(cfg, os.path.join(d, str(native)),
                                                        use_native_pager=native, device=device)
            c = cloud.from_points(pts, device=device)
            dmap.add_feature_cloud(c, c)
            for pos in ([60.0, 0, 0], [120.0, 0, 0], [0.0, 0, 0]):
                dmap.page(torch.tensor(pos, device=device))
            dmap.save()
            corner, _ = dmap.get_surround(torch.zeros(3, device=device))
            xyz = corner.xyz[corner.mask].cpu().numpy()
            got.append(xyz[np.lexsort(xyz.T)])
    want = pts[np.lexsort(pts.T)]
    same = got[0].shape == got[1].shape == want.shape and np.array_equal(got[0], got[1])
    err = float(np.abs(got[0] - want).max()) if got[0].shape == want.shape else float("inf")
    log(f"    native vs numpy pager, out and back: surround points equal {same}, "
        f"{len(got[0])} of {len(pts)} points back, max |dx| {err:.3g} (<= 1e-5)")
    if not (same and err <= 1e-5):
        fail("the native and numpy pagers disagree")
    return same


def map_cloud(quick, device):
    """The map a mapping run produced: every valid point of the Quick start's
    49 sweeps placed by its merged pose (numpy [N, 3])."""
    parts = []
    for sw, T in zip(quick["sweeps"], quick["merged"]):
        T = torch.from_numpy(T).to(device)
        p = sw.xyz[sw.mask].to(device)
        parts.append(p @ T[:3, :3].T + T[:3, 3])
    return torch.cat(parts).cpu().numpy()


def convert_phase(quick, tally, device):
    """io/feature_extracter.convert_map_for_localization on the card (the
    k-NN kernel at k = 10 over the whole cloud), its kernel against
    knn_plain, its labels against the CPU's; then load_feature_map and
    SlamPipeline(mode='localization') on the converted map."""
    import tempfile

    from cooper_mapper_torch.config import MapConfig, PipelineConfig
    from cooper_mapper_torch.io import evaluation, map_io, pcd
    from cooper_mapper_torch.io import feature_extracter as fe
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.ops import knn

    t0 = time.perf_counter()
    xyz = map_cloud(quick, device)
    n = len(xyz)
    cfg = MapConfig()
    log(f"[31] offline map converter: phase 16's 49 sweeps placed by its merged poses ({n} "
        f"points), write_pcd, convert_map_for_localization at the default MapConfig on {device}")
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "map.pcd"), os.path.join(d, "converted")
        pcd.write_pcd(src, xyz)
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_cubes = fe.convert_map_for_localization(src, out, cfg, device=device)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t1
        launches, merges = read_launches(), read_merges()
        add_counts(tally, launches, merges)
        with open(os.path.join(out, "index.txt")) as f:
            rows = [line.split() for line in f if line.strip()]
        map_state = map_io.load_feature_map(out, cfg, device)
    want = dict.fromkeys(launches, 0)
    want["knn"] = 1
    log(f"    convert {convert_s:.2f} s (read, classify, insert, save); launches {launches}, "
        f"merges {merges['knn']}")
    if launches != want:
        fail(f"the converter launched {launches}, expected one k-NN launch")

    # the converter's search: the kernel at its shape against knn_plain on a subset
    pts = torch.from_numpy(xyz).to(device)
    mask = torch.ones(n, dtype=torch.bool, device=device)
    idx, dist = knn.knn(pts[None], pts, mask, CONVERT_K)
    rng = np.random.RandomState(0)
    sub = torch.from_numpy(np.sort(rng.choice(n, CONVERT_CHECKED, replace=False))).to(device)
    p_idx, p_dist = knn.knn_plain(pts[sub][None], pts, mask, CONVERT_K)
    torch.cuda.synchronize()
    same = torch.equal(idx[:, sub], p_idx) and torch.equal(dist[:, sub], p_dist)
    err = float((dist[:, sub] - p_dist).abs().max())
    plan = races_plan(1, n, n, CONVERT_K)
    log(f"    k-NN kernel at the converter's shape [1 x {n} vs {n}, k = {CONVERT_K}, plan "
        f"{plan}] against knn_plain on {CONVERT_CHECKED} queries: indices and distances "
        f"bit-identical {same}")
    if not same:
        fail("the converter's k-NN kernel disagrees with knn_plain")

    # labels: the card's against the CPU's, both from the card's neighbours
    nb = idx[0].long()
    ev_card = fe.eigenvalues(pts, nb)
    ev_cpu = fe.eigenvalues(pts.cpu(), nb.cpu())
    (s_card, c_card), (s_cpu, c_cpu) = fe.labels(ev_card), fe.labels(ev_cpu)
    differ = ((s_card.cpu() != s_cpu) | (c_card.cpu() != c_cpu)).numpy()
    margin = torch.minimum(fe.threshold_margin(ev_card).cpu(), fe.threshold_margin(ev_cpu)).numpy()
    n_surf, n_corner = int(s_card.sum()), int(c_card.sum())
    stored = {t: sum(int(r[0]) for r in rows if r[1] == str(t)) for t in (0, 1)}
    log(f"    labels card vs CPU (eigvalsh of the same neighbourhoods): {int(differ.sum())} of {n} "
        f"differ (<= {LABEL_SHARE:.1%}), all within {LABEL_MARGIN} of a threshold "
        f"{bool(np.all(margin[differ] < LABEL_MARGIN))} ({int((margin < LABEL_MARGIN).sum())} "
        f"points are)")
    log(f"    surf {n_surf}, corner {n_corner}; {n_cubes} cube files; stored surf {stored[1]}, "
        f"corner {stored[0]}: the cubes dropped {n_surf - stored[1]} surf and "
        f"{n_corner - stored[0]} corner points (capacities {cfg.surf_cube_capacity} / "
        f"{cfg.corner_cube_capacity} per {cfg.cube_size:.0f} m cube)")
    if differ.sum() > LABEL_SHARE * n or not np.all(margin[differ] < LABEL_MARGIN):
        fail("the converter's labels on the card disagree with the CPU's")

    # times at the converter's shape (the plain version and the library on a subset)
    q_all = pts[None]
    ms = time_ms(lambda: knn.knn(q_all, pts, mask, CONVERT_K), reps=3, warmup=1)
    dev_ms, per_call, _, by_kernel = device_ms(
        lambda: knn.knn(q_all, pts, mask, CONVERT_K), ("knn_kernel", "merge_first_k"), reps=3)
    q_t = pts[sub[:CONVERT_TIMED]][None]
    plain_ms = time_ms(lambda: knn.knn_plain(q_t, pts, mask, CONVERT_K), reps=2, warmup=1)
    library_ms = time_ms(lambda: torch.cdist(q_t, pts[None]).square_()
                         .topk(CONVERT_K, largest=False), reps=2, warmup=1)
    pairs = n * n
    t_ops = pairs * OPS_PER_PAIR["knn"] / FP32_PEAK_OPS * 1e3
    t_bytes = (n * 12 + n + n * 12 + n * CONVERT_K * 8) / HBM_BYTES_PER_S * 1e3
    row = dict(shape=f"1x{n} vs {n}, k = {CONVERT_K}", valid_ref=n, pairs=pairs, err=err, ms=ms,
               device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
               timed_subset=f"plain and library on {CONVERT_TIMED} queries",
               bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
               plan=list(plan), where="phase 31, the offline converter")
    log(f"    knn converter [1x{n} vs {n}, k = {CONVERT_K}, {pairs:.3g} valid pairs]: kernel "
        f"{ms:.3f} ms, device {fmt_ms(dev_ms, 3)} ms ({per_call:g} launches per call, "
        f"{by_kernel}); "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); on {CONVERT_TIMED} queries: plain "
        f"{plain_ms:.3f} ms, library (cdist, topk(10)) {library_ms:.3f} ms")

    # localize on the converted map over the same sweeps, seeded at the first merged pose
    pipe = SlamPipeline(PipelineConfig(), "localization", map_state=map_state,
                        initial_pose=quick["merged"][0], device=device)
    results, loc_ms, launches, _ = drive_pipeline(pipe, quick["sweeps"], "converted map")
    tally_drive(tally, launches)
    est = np.stack([r.merged_pose for r in results])
    ate = evaluation.pipeline_ate(est, quick["poses"]).rmse
    err_map = np.linalg.norm(est[:, :3, 3] - quick["merged"][:, :3, 3], axis=-1)
    st = pipe.stats()
    log(f"    localization on the converted map: stats {st}; steady error (mean from the third "
        f"sweep) {float(err_map[2:].mean()):.4f} m against the mapping run's poses, whose map "
        f"it is; pipeline_ate {ate:.4f} m against the simulator (printed, not gated); ms per "
        f"sweep {ms_brief(loc_ms)}")
    if not np.isfinite(est).all():
        fail("localization on the converted map gave a non-finite pose")
    seconds = time.perf_counter() - t0
    log(f"    phase 31: {seconds:.1f} s")
    return dict(row=row, n=n, n_surf=n_surf, n_corner=n_corner, cubes=n_cubes,
                dropped=(n_surf - stored[1], n_corner - stored[0]), differ=int(differ.sum()),
                steady=float(err_map[2:].mean()), ate=ate,
                convert_s=convert_s, seconds=seconds, stats=st)


def races_plan(B, Q, M, k):
    """The k-NN's (S, L) split plan at a shape."""
    from cooper_mapper_torch.ops import races

    return races._split_plan(B, Q, M, races.sm_count("cuda"), knn_block_queries(k))


def bag_phase(sweeps, truth, tally, device):
    """The run_offline.py --bag flow: phase 9's sweeps as PointCloud2 (the
    raw axis order) with IMU and odometry messages in a bz2 bag,
    bag_to_npz, organize_unordered and the native binner, and the replay
    through SlamPipeline."""
    import tempfile

    from cooper_mapper_torch import build
    from cooper_mapper_torch.config import vlp16
    from cooper_mapper_torch.io import native_binner, rosbag
    from cooper_mapper_torch.models import scan_registration as sr
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.utils import se3

    t0 = time.perf_counter()
    log(f"[32] bag replay: phase 9's {len(sweeps)} sweeps as sensor_msgs/PointCloud2, "
        f"{IMU_SAMPLES} sensor_msgs/Imu and one nav_msgs/Odometry per sweep, a bz2 bag, "
        f"bag_to_npz, organize_unordered (VLP16) and bin_sweep_native, SlamPipeline on {device}")
    msgs = []
    for i, sw in enumerate(sweeps):
        stamp = 10.0 + 0.1 * i
        xyz = sw.xyz[sw.mask].cpu().numpy()[:, [2, 0, 1]]     # the sensor's raw axis order
        msgs.append(("/multi_scan_points", "sensor_msgs/PointCloud2", stamp,
                     rosbag.encode_pointcloud2(xyz, stamp)))
        for k in range(IMU_SAMPLES):
            t = stamp + 0.1 * k / IMU_SAMPLES
            msgs.append(("/imu/data", "sensor_msgs/Imu", t,
                         rosbag.encode_imu(t, [0, 0, 0, 1], [0.0, 0.0, 0.0], [0.0, 9.81, 0.0])))
        T = truth[i + 1]
        q = se3.rot_to_quat(torch.from_numpy(T[:3, :3])).numpy()          # (w, x, y, z)
        msgs.append(("/fpd", "nav_msgs/Odometry", stamp,
                     rosbag.encode_odometry(stamp, T[:3, 3].tolist(), [*q[1:], q[0]])))
    cfg = vlp16()
    with tempfile.TemporaryDirectory() as d:
        bag, npz = os.path.join(d, "drive.bag"), os.path.join(d, "npz")
        t1 = time.perf_counter()
        rosbag.write_bag(bag, msgs, compression="bz2")
        info = rosbag.bag_to_npz(bag, npz)
        bag_s = time.perf_counter() - t1
        raw = [np.load(os.path.join(npz, f"sweep_{i:06d}.npz"))["xyz"] for i in range(len(sweeps))]
        bag_mb = os.path.getsize(bag) / 2**20
    log(f"    bag {bag_mb:.2f} MiB, written and converted in {bag_s:.2f} s: {info}")
    if (info["n_sweeps"], info["n_imu"], info["n_gt"]) != (len(sweeps), IMU_SAMPLES * len(sweeps),
                                                           len(sweeps)):
        fail("bag_to_npz did not give back the bag's messages")

    organized, cells, org_ms, bin_ms, bad_ring, bad_rel = [], [0, 0], [], [], 0, 0
    for pts in raw:
        t1 = time.perf_counter()
        s = sr.organize_unordered(pts, cfg.registration, sr.VLP16, device=device)
        torch.cuda.synchronize()
        org_ms.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        b_xyz, b_mask, b_rel = native_binner.bin_sweep_native(pts, RINGS, WIDTH)
        bin_ms.append((time.perf_counter() - t1) * 1e3)
        organized.append(s)
        cells[0] += int(s.mask.sum())
        cells[1] += int(b_mask.sum())
        # tests/test_io.py::TestNativeBinner's gates
        got = b_xyz[b_mask]
        va = np.rad2deg(np.arctan2(got[:, 1], np.hypot(got[:, 0], got[:, 2])))
        rings = np.repeat(np.arange(RINGS), b_mask.sum(1))
        bad_ring += int((np.abs(va - (-15 + 2 * rings)) >= 1.01).sum())
        bad_rel += sum(int((np.diff(b_rel[r][b_mask[r]]) < 0).sum()) for r in range(RINGS))
    with open(os.path.join(build.BUILD_DIR, "libsweep_binner.log")) as f:
        openmp = "-fopenmp" in f.read().strip().splitlines()[-1]
    log(f"    the binner built from native/sweep_binner.cpp with OpenMP {openmp}")
    log(f"    valid cells over {len(raw)} sweeps: organize_unordered {cells[0]} "
        f"({np.median(org_ms):.2f} ms per sweep, median, to the card), bin_sweep_native "
        f"{cells[1]} ({np.median(bin_ms):.2f} ms per sweep, median); the binner's points off "
        f"their ring's angle by >= 1.01 deg {bad_ring}, rel_time steps backwards {bad_rel}")
    if bad_ring or bad_rel or cells[1] == 0:
        fail("the native binner broke tests/test_io.py::TestNativeBinner's gates")

    pipe = SlamPipeline(cfg, "mapping", device=device)
    results, ms, launches, _ = drive_pipeline(pipe, organized, "bag replay")
    tally_drive(tally, launches)
    gt = np.linalg.inv(truth[1]) @ truth[-1]
    est = np.stack([r.merged_pose for r in results])
    err = float(np.linalg.norm(est[-1, :3, 3] - gt[:3, 3]))
    log(f"    replay: stats {pipe.stats()}; final position error {err:.4f} m (< {BAG_TOL}); "
        f"ms per sweep {ms_brief(ms)}")
    if not (np.isfinite(est).all() and err < BAG_TOL):
        fail("the bag replay left test_bag_feeds_pipeline's bound")
    seconds = time.perf_counter() - t0
    log(f"    phase 32: {seconds:.1f} s")
    return dict(err=err, cells=cells, org_ms=float(np.median(org_ms)),
                bin_ms=float(np.median(bin_ms)), bag_s=bag_s, seconds=seconds)


TRACED_KERNELS = ("nn1_kernel", "masked_kernel", "bc_races_kernel", "knn_kernel")


def trace_phase(tally, device, n=5):
    """One dynamic-mode mapping sweep inside utils/profiling.trace: the trace
    file names the race kernels and the k-NN kernel."""
    import tempfile

    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.utils import profiling

    t0 = time.perf_counter()
    log(f"[33] utils/profiling.trace around sweep {n - 1} (a map solve) of a dynamic-mode drive "
        f"over the corridor's first {n} sweeps")
    sweeps, _ = corridor_sweeps(device, n_out=n, n_back=0)
    with tempfile.TemporaryDirectory() as d:
        pipe = SlamPipeline(corridor_cfg(os.path.join(d, "map")), "mapping", device=device)
        reset_launches()
        for sw in sweeps[:-1]:
            pipe.process(sw)
        with profiling.trace(os.path.join(d, "trace")):
            r = pipe.process(sweeps[-1])
        torch.cuda.synchronize()
        add_counts(tally, read_launches(), read_merges())
        files = os.listdir(os.path.join(d, "trace"))
        with open(os.path.join(d, "trace", files[0])) as f:
            text = f.read()
        size = len(text)
    named = {k: text.count(k) for k in TRACED_KERNELS}
    log(f"    {files}: {size} bytes; events naming each kernel {named}; the sweep solved the map "
        f"{r.mapping_success is not None}")
    if len(files) != 1 or not all(named.values()) or r.mapping_success is None:
        fail("the trace does not name the race and k-NN kernels of a map-solving sweep")
    seconds = time.perf_counter() - t0
    log(f"    phase 33: {seconds:.1f} s")
    return dict(named=named, seconds=seconds)


# The parallel layer: parallel/batch, maps/sharded_map and SlamPipeline(map_mesh)
# on torch.distributed, with tests/test_parallel.py's and tests/test_sharded_map.py's
# tolerances
PAR_ODO_TOL = 1e-4                       # TestShardedOdometry
PAR_COST_RTOL, PAR_DENSE_TOL, PAR_CG_TOL = 1e-4, 5e-3, 1e-2   # TestShardedPoseGraph(Cg)
PAR_PG_NEAR = 12                         # the nodes those tests compare: poses[:12]
PAR_PIPE_TOL = 2.5e-2                    # tests/test_sharded_map.py::TestShardedPipeline
KEEPS = (1.0, 1.0, 0.6, 0.6, 0.25, 0.25)  # TestBucketedOdometry's keep fractions
BUCKET_GRANULE, BUCKET_CHUNK = 512, 256   # benchmarks/bench_hetero.py's defaults
BUCKET_TOL, BUCKET_ITERS = 2e-4, 8        # TestBucketedOdometry's bound and iterations
PAR_RANKS, PAR_MAP_SWEEPS, PAR_LM_REPS = 2, 6, 1
# seconds: phase 36's ranks in all, and a collective's wait for the other rank
PAR_TIMEOUT, PAR_GROUP_TIMEOUT = 600.0, 300.0


def pipe13_cfg():
    """Phase 13's PipelineConfig (TestImuFusion's stride and cool-down)."""
    from cooper_mapper_torch.config import PipelineConfig, UKFConfig

    return PipelineConfig(mapping_stride=1, ukf=UKFConfig(cool_time_duration=0.0))


def race_launches(cfg, n=1):
    """The split races' launches of ``n`` odometry batch solves at B = 512
    (phase 4's expectation)."""
    blocks = -(-cfg.max_iterations // cfg.refresh_every)
    return {"nn1": 2 * blocks * n, "nn1_masked": blocks * n, "bc_races": blocks * n,
            "fused_races": 0, "merge_min": 0, "knn": 0}


def lm_timed(g, cfg, mesh, reps=PAR_LM_REPS):
    """``sharded_pose_graph_optimize`` ``reps`` times: (graph, diag, LM
    iterations/s best and median)."""
    from cooper_mapper_torch.parallel import batch

    its = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, diag = batch.sharded_pose_graph_optimize(g, cfg, mesh)
        torch.cuda.synchronize()
        its.append(cfg.max_iterations / (time.perf_counter() - t0))
    return out, diag, (max(its), float(np.median(its)))


def one_rank_phase(bench, scan, pg_run, pipe13, sweeps, tally, device):
    """[34] a mesh of one rank under NCCL: every sharded path against the
    unsharded run of the same inputs earlier in the script, bit for bit."""
    import tempfile

    from cooper_mapper_torch.config import OdometryConfig, ScanMatchConfig
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.ops import odometry
    from cooper_mapper_torch.parallel import batch, distributed, mesh as mesh_lib

    sharp, flat, ref_c, ref_s, x0, x4, st4, sps4 = bench
    corner_b, surf_b, map_c, map_s, x0_sm, res7, sps7 = scan
    t0 = time.perf_counter()
    log(f"[34] the parallel layer on a mesh of one rank (torch.distributed; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}): every sharded path against the "
        f"unsharded run earlier in this script, bit for bit")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        distributed.initialize(f"file://{d}/store", 1, 0, device=device)
        try:
            mesh = mesh_lib.make_mesh()
            log(f"    mesh: size {mesh.size}, rank {mesh.rank}, {mesh.device}, backend "
                f"{torch.distributed.get_backend(mesh.group)}")
            cfg = OdometryConfig()
            (x, st), launches, _ = counted(tally, lambda: batch.sharded_odometry_solve(
                sharp, flat, ref_c, ref_s, x0, cfg, mesh))
            same = torch.equal(x, x4) and all(torch.equal(getattr(st, f.name), getattr(st4, f.name))
                                              for f in dataclasses.fields(st))
            sps = solves_per_s({"sharded": lambda: batch.sharded_odometry_solve(
                                    sharp, flat, ref_c, ref_s, x0, cfg, mesh),
                                "unsharded": lambda: odometry.batch_odometry_solve(
                                    sharp, flat, ref_c, ref_s, x0, cfg)}, x0.shape[0])
            log(f"    sharded_odometry_solve B={x0.shape[0]}: launches {launches}; x and states "
                f"bit-identical to phase 4's {same}; solves/s best / median: sharded "
                f"{sps['sharded'][0]:.1f} / {sps['sharded'][1]:.1f}, unsharded in turns "
                f"{sps['unsharded'][0]:.1f} / {sps['unsharded'][1]:.1f} (phase 4: {sps4[0]:.1f} / "
                f"{sps4[1]:.1f})")
            if launches != race_launches(cfg) or not same:
                fail("the one-rank sharded odometry solve differs from phase 4's")
            out["odometry"] = dict(x=x, sps=sps)

            sm_cfg = ScanMatchConfig()
            res, launches, merges = counted(tally, lambda: batch.sharded_scan_match(
                corner_b, surf_b, map_c, map_s, x0_sm, sm_cfg, mesh))
            same = all(torch.equal(getattr(res, f.name), getattr(res7, f.name))
                       for f in dataclasses.fields(res))
            sm_sps = solves_per_s({"sharded": lambda: batch.sharded_scan_match(
                corner_b, surf_b, map_c, map_s, x0_sm, sm_cfg, mesh)}, x0_sm.shape[0])
            log(f"    sharded_scan_match B={x0_sm.shape[0]}: launches {launches}, merges {merges}; "
                f"every result field bit-identical to phase 7's {same}; solves/s "
                f"{sm_sps['sharded'][0]:.1f} / {sm_sps['sharded'][1]:.1f} (phase 7: "
                f"{sps7[0]:.1f} / {sps7[1]:.1f})")
            if launches["knn"] != 2 * (sm_cfg.max_iterations + 1) or not same:
                fail("the one-rank sharded scan match differs from phase 7's")
            out["scan_match"] = sm_sps["sharded"]

            for solver in ("dense", "cg"):
                g, pg_cfg = pose_graph_problem(PG_NODES, solver, device)
                got, diag, its = lm_timed(g, pg_cfg, mesh)
                same = torch.equal(got.poses, pg_run["poses"][solver])
                ref = pg_run[solver]["iters_per_s"]
                log(f"    sharded_pose_graph_optimize {solver} n={PG_NODES}: cost "
                    f"{float(diag['initial_cost']):.6g} -> {float(diag['final_cost']):.6g}; "
                    f"poses bit-identical to phase 18's {same}; LM iterations/s best / median "
                    f"{its[0]:.2f} / {its[1]:.2f} (phase 18: {ref[0]:.2f} / {ref[1]:.2f})")
                if not same:
                    fail(f"the one-rank sharded LM ({solver}) differs from phase 18's")
                out[f"lm_{solver}"] = dict(its=its, cost=(float(diag["initial_cost"]),
                                                          float(diag["final_cost"])),
                                           poses=got.poses)

            pipe = SlamPipeline(pipe13_cfg(), "mapping", map_mesh=mesh)
            _, ms, launches, _ = drive_pipeline(pipe, sweeps, "map_mesh of one", imu=True)
            tally_drive(tally, launches)
            traj = np.stack(pipe.trajectory)
            same_t = bool(np.array_equal(traj, pipe13["trajectory"]))
            same_m = maps_equal(pipe.single_map_state(), pipe13["map"])
            log(f"    SlamPipeline(map_mesh=mesh) over phase 13's drive (IMU windows): poses "
                f"bit-identical to phase 13's {same_t}, single_map_state() bit-identical {same_m}; "
                f"ms per sweep {ms_stat(ms)}")
            if not (same_t and same_m):
                fail("SlamPipeline on a mesh of one differs from phase 13's drive")
            out["pipeline_ms"] = ms
        finally:
            distributed.shutdown()
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 34: {out['seconds']:.1f} s")
    return out


def shrink_lanes(cl, keeps, B):
    """``cl`` (unbatched, front-packed) tiled to B problems, problem b keeping
    its first max(keeps[b % len(keeps)] * n, 40) valid points
    (TestBucketedOdometry._hetero_batch)."""
    from cooper_mapper_torch.utils import cloud

    n = int(cl.mask.sum())
    keep = torch.tensor([max(int(keeps[b % len(keeps)] * n), 40) for b in range(B)],
                        device=cl.xyz.device)
    t = tile(cl, B)
    rank = torch.cumsum(t.mask.to(torch.int32), dim=1) - 1
    m = t.mask & (rank < keep[:, None])
    return cloud.Cloud(torch.where(m[..., None], t.xyz, cloud.FAR), m, t.ring, t.rel_time)


def full_capacity_by_dispatch(clouds, x0, cfg, plan):
    """The full-capacity batch solve of each dispatch's problems (its rows,
    repeat padding included, at the clouds' own capacities): (x, n_matched)
    in input order.  It differs from the bucketed solve only by the bucket
    truncation; cuBLAS's batched products pick their reduction by batch
    size, so a solve of all B problems at once sums in another order."""
    from cooper_mapper_torch.ops import odometry
    from cooper_mapper_torch.utils.cloud import Cloud

    x, n = torch.empty_like(x0), torch.empty(x0.shape[0], device=x0.device)
    for _, _, sl, idx in plan[1]:
        rows = torch.from_numpy(idx).to(x0.device)
        pick = lambda c: Cloud(*(t.index_select(0, rows)
                                 for t in (c.xyz, c.mask, c.ring, c.rel_time)))
        xd, st = odometry.batch_odometry_solve(*(pick(c) for c in clouds), x0[rows], cfg)
        x[sl], n[sl] = xd[:len(sl)], st.n_matched[:len(sl)]
    return x, n


def bucketed_phase(sharp1, flat1, ref_c, ref_s, x0, tally):
    """[35] bucketed_odometry_solve at B = 512 on the bench pair with
    TestBucketedOdometry's keep fractions, against the full-capacity batch
    solve of the same problems: per dispatch (gated), and all B at once
    (printed), at the test's 8 GN iterations and the default 25."""
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry
    from cooper_mapper_torch.parallel import batch

    B = x0.shape[0]
    cfg = OdometryConfig()
    t0 = time.perf_counter()
    log(f"[35] bucketed_odometry_solve: B={B} problems of the bench pair (per-problem "
        f"references), problem b keeping a fraction {KEEPS}[b % 6] of each cloud's points, "
        f"granule {BUCKET_GRANULE}, chunk {BUCKET_CHUNK}; TestBucketedOdometry's "
        f"max_iterations={BUCKET_ITERS}, then the default OdometryConfig")
    clouds = [shrink_lanes(c, KEEPS, B) for c in (sharp1, flat1, ref_c, ref_s)]
    plan = batch.bucket_plan(*clouds, BUCKET_GRANULE, BUCKET_CHUNK)
    front_packed, dispatches = plan
    log(f"    plan: front-packed {front_packed}; {len(dispatches)} dispatches "
        + "; ".join(f"caps {caps} x {take_n} ({len(sl)} problems)"
                    for caps, take_n, sl, _ in dispatches)
        + f"; full capacities {tuple(c.capacity for c in clouds)}; valid points of problems "
        f"0..5 (sharp, flat, less_sharp, less_flat) "
        f"{[tuple(int(c.mask[b].sum()) for c in clouds) for b in range(len(KEEPS))]}")
    out = {}
    for iters in (BUCKET_ITERS, cfg.max_iterations):
        c = dataclasses.replace(cfg, max_iterations=iters)
        (xb, stb), launches, merges = counted(tally, lambda: batch.bucketed_odometry_solve(
            *clouds, x0, c, plan=plan))
        xd, nd = full_capacity_by_dispatch(clouds, x0, c, plan)
        xf, stf = odometry.batch_odometry_solve(*clouds, x0, c)
        dx = float((xb - xd).abs().max())
        same_n = torch.equal(stb.n_matched, nd)
        by_keep = [float((xb - xf)[k::len(KEEPS)].abs().max()) for k in range(len(KEEPS))]
        want = race_launches(c, len(dispatches))
        log(f"    max_iterations={iters}: launches {launches} (expected {want}), merges "
            f"{merges}; max |dx| against the full-capacity solve of each dispatch's problems "
            f"{dx:.3g} (< {BUCKET_TOL}), n_matched equal {same_n}; against one full-capacity "
            f"solve of all {B}, by problem b % 6 {['%.3g' % v for v in by_keep]}, n_matched "
            f"equal on {int((stb.n_matched == stf.n_matched).sum())} of {B} (printed)")
        if launches != want or not (dx < BUCKET_TOL and same_n and torch.isfinite(xb).all()):
            fail("the bucketed solve left TestBucketedOdometry's bounds")
        out[iters] = dict(dx=dx, by_keep=by_keep)
    sps = solves_per_s({"bucketed": lambda: batch.bucketed_odometry_solve(
                            *clouds, x0, cfg, plan=plan, with_states=False),
                        "homogeneous": lambda: odometry.batch_odometry_solve(*clouds, x0, cfg)},
                       B)
    log(f"    default OdometryConfig, solves/s best / median, in turns: bucketed "
        f"{sps['bucketed'][0]:.1f} / {sps['bucketed'][1]:.1f}, homogeneous full capacity "
        f"{sps['homogeneous'][0]:.1f} / {sps['homogeneous'][1]:.1f}")
    seconds = time.perf_counter() - t0
    log(f"    phase 35: {seconds:.1f} s")
    return dict(plan=[(caps, take_n, len(sl)) for caps, take_n, sl, _ in dispatches],
                dx=out[BUCKET_ITERS]["dx"], diffs=out, sps=sps, seconds=seconds)


def striped_map_check(pcfg, sweeps, truth, mesh, device, say):
    """The striped map against the single-device map at ``pcfg``'s map (the
    default MapConfig) on phase 9's first PAR_MAP_SWEEPS sweeps' features,
    placed at their end poses: inserts and recentres, the surround's point
    set, dedup, and a recentre 500 m on that clears cubes; bit for bit after
    each."""
    from cooper_mapper_torch.maps import feature_map as fm
    from cooper_mapper_torch.maps import sharded_map as smap
    from cooper_mapper_torch.models.laser_mapping import _to_world
    from cooper_mapper_torch.ops import features

    cfg, reg = pcfg.feature_map, pcfg.registration
    single, striped = fm.create(cfg, device), smap.create_sharded(cfg, mesh)
    held = map_bytes(striped)
    for i, sw in enumerate(sweeps[:PAR_MAP_SWEEPS]):
        f = features.extract_features(sw, reg)
        T = torch.from_numpy(truth[i + 1]).to(device)
        c, s = _to_world(f.less_sharp, T), _to_world(f.less_flat, T)
        fm.add_feature_cloud(single, c, s, cfg)
        smap.add_feature_cloud(striped, c, s, cfg, mesh)
        fm.recenter(single, T[:3, 3], cfg)
        smap.recenter(striped, T[:3, 3], cfg, mesh)
    checks = {"insert": maps_equal(smap.to_single(striped, cfg, mesh), single)}
    pos = T[:3, 3]
    pts = lambda cl: sorted(map(tuple, cl.xyz[cl.mask].cpu().numpy().tolist()))
    got, want = smap.get_surround(striped, pos, cfg, mesh), fm.get_surround(single, pos, cfg)
    checks["surround"] = all(pts(a) == pts(b) for a, b in zip(got, want))
    n_sur = [(int(a.mask.sum()), int(b.mask.sum())) for a, b in zip(got, want)]
    fm.dedup_active(single, pos, cfg)
    smap.dedup_active(striped, pos, cfg, mesh)
    checks["dedup"] = maps_equal(smap.to_single(striped, cfg, mesh), single)
    far = pos + torch.tensor([0.0, 0.0, 500.0], device=device)
    fm.recenter(single, far, cfg)
    smap.recenter(striped, far, cfg, mesh)
    checks["recenter"] = maps_equal(smap.to_single(striped, cfg, mesh), single)
    say(f"striped map ({cfg.n_cubes} cubes, {held / 2**20:.1f} MiB in this rank's stripe, "
        f"the single map {map_bytes(single) / 2**20:.1f} MiB): surround corner / surf points, "
        f"striped and single, {n_sur}; after the inserts, surround, dedup and the 500 m recentre "
        f"(origin {single.origin.tolist()}) equal to the single map: {checks}")
    return checks, held


def two_rank_child(rank, world, d, backend, device):
    """One rank of phase 36 (a spawned process): the sharded paths on half
    of phase 34's work each, against phase 34's results in ``d``/inputs.pt."""
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.models.pipeline import SlamPipeline
    from cooper_mapper_torch.ops.features import Sweep
    from cooper_mapper_torch.parallel import batch, distributed, mesh as mesh_lib
    from cooper_mapper_torch.utils.cloud import Cloud

    os.environ["COOPER_PALLAS_FUSED"] = "0"
    say = lambda msg: log(f"    [36 rank {rank}] {msg}")
    device = distributed.initialize(f"file://{d}/store", world, rank, device=device,
                                    backend=backend, timeout=PAR_GROUP_TIMEOUT)
    mesh = mesh_lib.make_mesh(device=device)
    inp = torch.load(os.path.join(d, "inputs.pt"), map_location=device)
    cl = lambda k: Cloud(*inp[k])
    tally, out = {}, {}
    torch.cuda.reset_peak_memory_stats(device)

    cfg = OdometryConfig()
    (x, _), launches, _ = counted(tally, lambda: batch.sharded_odometry_solve(
        cl("sharp"), cl("flat"), cl("ref_c"), cl("ref_s"), inp["x0"], cfg, mesh))
    dx = float((x - inp["x"]).abs().max())
    say(f"sharded_odometry_solve B={inp['x0'].shape[0]} ({inp['x0'].shape[0] // world} rows "
        f"here): launches {launches}; max |dx| against phase 34 {dx:.3g} (< {PAR_ODO_TOL})")
    if launches != race_launches(cfg) or not dx < PAR_ODO_TOL:
        fail(f"rank {rank}: the sharded odometry solve left {PAR_ODO_TOL} of phase 34's")
    out["odometry_dx"] = dx

    for solver, tol in (("dense", PAR_DENSE_TOL), ("cg", PAR_CG_TOL)):
        g, pg_cfg = pose_graph_problem(PG_NODES, solver, device)
        # one run: at two ranks on one card a dense LM iteration moves its
        # 151 MB Hessian through the host and gloo
        got, diag, its = lm_timed(g, pg_cfg, mesh, reps=1)
        c0, c1 = float(diag["initial_cost"]), float(diag["final_cost"])
        ref0, ref1 = (float(v) for v in inp[f"lm_{solver}_cost"])
        dpos = (got.poses - inp[f"lm_{solver}"]) if solver == "dense" else (
            got.poses[:, :3, 3] - inp[f"lm_{solver}"][:, :3, 3])
        dp = float(dpos[:PAR_PG_NEAR].abs().max())
        say(f"sharded_pose_graph_optimize {solver} n={PG_NODES} ({g.edge_i.shape[0] // world} "
            f"edges here): cost {c0:.6g} -> {c1:.6g} (phase 34: -> {ref1:.6g}), initial cost "
            f"vs phase 34 relative {abs(c0 - ref0) / ref0:.3g} (< {PAR_COST_RTOL}); max "
            f"|d{'pose' if solver == 'dense' else 'position'}| over nodes 0..{PAR_PG_NEAR - 1} "
            f"{dp:.3g} (< {tol}), over all {float(dpos.abs().max()):.3g} (printed: the ring's "
            f"far nodes are weakly determined, phase 18's dense and CG part by up to "
            f"{inp['lm_dense_vs_cg']:.3g} m); LM iterations/s {its[0]:.2f}")
        if not (abs(c0 - ref0) <= PAR_COST_RTOL * ref0 and dp < tol and c1 < PG_COST_RATIO * c0):
            fail(f"rank {rank}: the sharded LM ({solver}) left TestShardedPoseGraph's bounds")
        out[f"lm_{solver}"] = dict(its=its, dp=dp)

    sweeps = [Sweep(*s) for s in inp["sweeps"]]
    truth = inp["truth"].cpu().numpy()
    checks, held = striped_map_check(pipe13_cfg(), sweeps, truth, mesh, device, say)
    if not all(checks.values()):
        fail(f"rank {rank}: the striped map differs from the single map: {checks}")
    out["map_checks"], out["stripe_bytes"] = checks, held

    pipe = SlamPipeline(pipe13_cfg(), "mapping", map_mesh=mesh)
    _, ms, launches, _ = drive_pipeline(pipe, sweeps, f"rank {rank} map_mesh", imu=True)
    tally_drive(tally, launches)
    traj = np.stack(pipe.trajectory)
    err = np.linalg.norm(traj[:, :3, 3] - inp["trajectory"].cpu().numpy()[:, :3, 3], axis=-1)
    single = pipe.single_map_state()
    say(f"SlamPipeline(map_mesh) over phase 13's drive: max position difference to the "
        f"single-device trajectory {float(err.max()):.4g} m (< {PAR_PIPE_TOL}), final "
        f"{float(err[-1]):.4g} m; gathered map points {int(single.corner.count.sum())} corner / "
        f"{int(single.surf.count.sum())} surf; stats {pipe.stats()}; ms per sweep {ms_stat(ms)}")
    if not float(err.max()) < PAR_PIPE_TOL:
        fail(f"rank {rank}: SlamPipeline(map_mesh) left {PAR_PIPE_TOL} m of the single device")
    out["pipe_err"], out["pipe_ms"] = float(err.max()), ms
    out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    say(f"peak memory {out['peak_mib']:.1f} MiB")
    out["tally"] = tally
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    distributed.shutdown()


def two_rank_phase(bench, one, pipe13, sweeps, truth, tally, device):
    """[36] two ranks: NCCL on two cards where there are two, else two
    processes on the one card under gloo (NCCL refuses two ranks on one
    card).  Every rank checks its results; a failing rank fails the run."""
    import multiprocessing as mp
    import tempfile

    sharp, flat, ref_c, ref_s, x0 = bench
    backend = "nccl" if torch.cuda.device_count() >= PAR_RANKS else "gloo"
    t0 = time.perf_counter()
    log(f"[36] the parallel layer on {PAR_RANKS} ranks: {backend}"
        + (" over CUDA tensors, both ranks on the one card" if backend == "gloo" else
           f" on {PAR_RANKS} cards") + " (spawned processes); each rank's checks below")
    cpu = lambda c: [t.cpu() for t in (c.xyz, c.mask, c.ring, c.rel_time)]
    inp = {"sharp": cpu(sharp), "flat": cpu(flat), "ref_c": cpu(ref_c), "ref_s": cpu(ref_s),
           "x0": x0.cpu(), "x": one["odometry"]["x"].cpu(),
           "sweeps": [[t.cpu() for t in (s.xyz, s.mask, s.rel_time)] for s in sweeps],
           "truth": torch.from_numpy(np.stack(truth)),
           "trajectory": torch.from_numpy(pipe13["trajectory"])}
    for solver in ("dense", "cg"):
        inp[f"lm_{solver}"] = one[f"lm_{solver}"]["poses"].cpu()
        inp[f"lm_{solver}_cost"] = torch.tensor(one[f"lm_{solver}"]["cost"])
    inp["lm_dense_vs_cg"] = float((inp["lm_dense"][:, :3, 3] - inp["lm_cg"][:, :3, 3])
                                  .norm(dim=-1).max())
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        torch.save(inp, os.path.join(d, "inputs.pt"))
        procs = [ctx.Process(target=two_rank_child, args=(r, PAR_RANKS, d, backend, device))
                 for r in range(PAR_RANKS)]
        for p in procs:
            p.start()
        # wait for every rank; one that fails ends the others (they would
        # wait at their next collective), and so does the time limit
        deadline = time.monotonic() + PAR_TIMEOUT
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.5)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            fail(f"phase 36: rank exit codes {codes} (ranks {hung} were still running, killed)")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                 for r in range(PAR_RANKS)]
    for r in ranks:
        for k, v in r.pop("tally").items():
            add_counts(tally, {k: v["launches"]}, {k: v["merges"]})
    seconds = time.perf_counter() - t0
    log(f"    phase 36: {seconds:.1f} s")
    return dict(backend=backend, ranks=ranks, seconds=seconds)


# The repo's entry scripts (phases 37-39): the offline runner at the HDL-64E
# and HDL-32 presets at full width, its --selftest as a user runs it, and the
# four demos at their defaults.
OFFLINE_SWEEPS, OFFLINE_WIDTH, OFFLINE_STEP_M, OFFLINE_CPU_SWEEPS = 12, 2048, 0.35, 4
OFFLINE_CPU_THREADS = 4          # each of the two CPU runs: 8 cores on the card's host
OFFLINE_CPU_TIMEOUT, SELFTEST_TIMEOUT = 420, 300
# sensor -> (phase, name, rings, the simulator's vertical fan: the ring mapper's)
OFFLINE_SENSORS = {"hdl64": (37, "HDL-64E", 64, (-24.9, 2.0)),
                   "hdl32": (38, "HDL-32", 32, (-30.67, 10.67))}
FEATURE_CLASSES = ("sharp", "less_sharp", "flat", "less_flat")
MOVED_SHARE = 1e-3              # cells whose internals may differ card vs CPU (phase 29)
# per sensor, the bound on max |dW| between the card's and the CPU's free
# runs at each of the first OFFLINE_CPU_SWEEPS sweeps.  HDL-64E's sweeps 2-3
# take the largest spread that a one-ulp move of the input files made
# between two runs on one device (diagnose_offline_divergence.py on the
# H100, PERF.md): from its second odometry solve on, that drive turns a
# rounding-size difference into up to 0.0133 m at sweep 2 and 0.0317 m at
# sweep 3, on the CPU alone.  The replay of each solve (lockstep_replay)
# holds the card to the CPU solve by solve.
OFFLINE_FREE_TOL = {"hdl64": (CPU_TOL, CPU_TOL, 0.014, 0.032),
                    "hdl32": (CPU_TOL, CPU_TOL, CPU_TOL, CPU_TOL)}


def sweep_launches(cfg, device):
    """The launches of one odometry sweep on the split route (phase 9's, once
    per de-warp pass), with the merges ``_split_plan`` implies on the card
    (none on the CPU), and the k-NN launches of one map solve."""
    passes = max(cfg.odometry.dewarp_passes, 1)
    race = {"nn1": 10 * passes, "nn1_masked": 5 * passes, "bc_races": 5 * passes,
            "fused_races": 0}
    merges = (split_race_merges(cfg, race["bc_races"], device)
              if torch.device(device).type == "cuda" else {})
    race["merge_min"] = sum(merges.values())
    return race, 2 * (cfg.scan_match.max_iterations + 1)


def host_copy(tree):
    """A copy of every tensor of ``tree`` on the host."""
    from cooper_mapper_torch.parallel.mesh import tree_map

    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def device_clone(tree):
    """A copy of every tensor of ``tree`` where it lies (no host read)."""
    from cooper_mapper_torch.parallel.mesh import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


class PipelineProbe:
    """Records every SlamPipeline a script builds (``module.SlamPipeline``
    patched for the block): per ``process`` call the synchronized ms, the
    sweep's valid cells and the kernels' launches; per map solve
    (``laser_mapping.mapping_step``) its score, gate and frame features; per
    solve the JtJ its degeneracy projector saw.  Inside the timed window it
    keeps device tensors only and reads none; they are read when the block
    ends.  With ``capture=n`` the solves of sweeps 1..n-1 are recorded for
    ``lockstep_replay``: the pipeline's state on the host, copied before
    the timed window, and each solve's inputs and outputs, cloned on the
    device (a few small copies inside the window)."""

    def __init__(self, module, capture=0):
        from cooper_mapper_torch.models import laser_mapping, laser_odometry
        from cooper_mapper_torch.ops import gauss_newton

        self.module, self.mapping, self.odometry = module, laser_mapping, laser_odometry
        self.gn, self.capture = gauss_newton, capture
        self.pipes, self.sweeps, self.solves, self.eigs, self.lockstep = [], [], [], [], []
        self._entry = None

    def __enter__(self):
        probe, base = self, self.module.SlamPipeline
        self._base, self._step = base, self.mapping.mapping_step
        self._odo_step, self._projector = self.odometry.step, self.gn.degeneracy_projector

        class Probed(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                probe.pipes.append(self)

            def process(self, sweep, *args, **kw):
                i = len(probe.sweeps)
                if 0 < i < probe.capture:
                    # the solves' state as this sweep finds it, before the window
                    probe._entry = dict(sweep=i, odo=host_copy(self.odo),
                                        matcher=host_copy(self.matcher),
                                        map=host_copy(self.map_state))
                sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
                before, merges = read_launches(), read_merges()
                sync()
                t0 = time.perf_counter()
                r = super().process(sweep, *args, **kw)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                after = read_launches()
                probe.sweeps.append(dict(ms=ms, cells=int(sweep.mask.sum()),
                                         launches={k: after[k] - before[k] for k in after},
                                         merges={k: v - merges[k]
                                                 for k, v in read_merges().items()},
                                         solved=r.mapping_success))
                if probe._entry is not None:
                    probe.lockstep.append(probe._entry)
                    probe._entry = None
                return r

        def odo_step(state, fc, cfg, *args, **kw):
            if probe._entry is not None:
                probe._entry.update(fc=device_clone(fc), odo_cfg=cfg)
            out = probe._odo_step(state, fc, cfg, *args, **kw)
            if probe._entry is not None:
                probe._entry["odo_out"] = device_clone(out[1])
            return out

        def step(matcher, map_state, *args, **kw):
            e = probe._entry
            if e is not None:
                e.update(map_args=device_clone(args), map_kw=kw)
            out = probe._step(matcher, map_state, *args, **kw)
            mo = out[2]
            probe.solves.append((mo.result.score, mo.result.success, mo.corner_ds.mask,
                                 mo.surf_ds.mask))
            if e is not None:
                e["map_out"] = device_clone(mo)
            return out

        def projector(JtJ, eig_threshold, *args, **kw):
            probe.eigs.append((JtJ.detach().clone(), eig_threshold))
            return probe._projector(JtJ, eig_threshold, *args, **kw)

        self.module.SlamPipeline = Probed
        self.mapping.mapping_step = step
        self.odometry.step = odo_step
        self.gn.degeneracy_projector = projector
        return self

    def __exit__(self, *exc):
        self.module.SlamPipeline = self._base
        self.mapping.mapping_step = self._step
        self.odometry.step = self._odo_step
        self.gn.degeneracy_projector = self._projector
        # the reads, after every timed window
        self.solves = [(round(float(s), 1), bool(ok), int(cm.sum()) + int(sm.sum()))
                       for s, ok, cm, sm in self.solves]
        for e in self.lockstep:
            if "map_out" not in e:          # no map solve in this sweep
                del e["map"], e["matcher"]
        self.lockstep = [host_copy(e) for e in self.lockstep]
        return False

    def smallest_eigenvalues(self):
        """Per threshold (10: odometry, 100: scan match), the smallest
        eigenvalue of JtJ at each solve's iteration 0, in solve order."""
        out = {}
        for JtJ, thr in self.eigs:
            ev = torch.linalg.eigvalsh(JtJ.reshape(-1, 6, 6)[0].double())
            out.setdefault(float(thr), []).append(round(float(ev[0]), 2))
        return out

    def tally(self, tally):
        """Add the recorded process calls' launches and merges to ``tally``."""
        for s in self.sweeps:
            add_counts(tally, s["launches"], s["merges"])


def ulp_moved(c, direction):
    """Cloud ``c`` with every valid point's coordinates one ulp up (+1) or
    down (-1): a move of rounding size."""
    far = torch.full_like(c.xyz, direction * float("inf"))
    return dataclasses.replace(c, xyz=torch.where(c.mask[:, None], torch.nextafter(c.xyz, far),
                                                  c.xyz))


def lockstep_replay(entries):
    """Each recorded solve again on this process's device (the CPU), from
    the card's own state and inputs: one solve's difference, free of what
    earlier sweeps carried in.  Per sweep: max |dT| of the odometry pose,
    the matched features on both, max |dxyz| of the end-projected clouds
    handed to the mapper, and, where max |dT| exceeds CPU_TOL (the bound
    it is then held to depends on it), the witness ``odo_ulp``: the largest move of the CPU's own odometry pose
    when every input point moves one ulp up or down (else None); for a map
    solve max |dW|, the scores and the points by which the downsampled
    frames differ."""
    from cooper_mapper_torch.models import laser_mapping, laser_odometry

    dmax = lambda a, b: float((a - b).abs().max())
    out = []
    for e in entries:
        _, oo = laser_odometry.step(e["odo"], e["fc"], e["odo_cfg"])
        card = e["odo_out"]
        odo, ulp = dmax(oo.T_sum, card.T_sum), []
        for d in ((1, -1) if odo > CPU_TOL else ()):
            fc = dataclasses.replace(e["fc"], **{n: ulp_moved(getattr(e["fc"], n), d)
                                                 for n in FEATURE_CLASSES})
            st = dataclasses.replace(e["odo"], last_corner=ulp_moved(e["odo"].last_corner, d),
                                     last_surf=ulp_moved(e["odo"].last_surf, d))
            ulp.append(dmax(laser_odometry.step(st, fc, e["odo_cfg"])[1].T_sum, oo.T_sum))
        row = dict(sweep=e["sweep"], odo=odo, odo_ulp=max(ulp, default=None),
                   matched=[int(oo.n_matched), int(card.n_matched)],
                   projected=max(dmax(oo.corner_for_map.xyz, card.corner_for_map.xyz),
                                 dmax(oo.surf_for_map.xyz, card.surf_for_map.xyz)))
        if "map_out" in e:
            # on a copy: the step updates the map in place
            _, _, mo = laser_mapping.mapping_step(e["matcher"], device_clone(e["map"]),
                                                  *e["map_args"], **e["map_kw"])
            cm = e["map_out"]
            pts = lambda c: {tuple(x) for x in c.xyz[c.mask].tolist()}
            row.update(map=dmax(mo.W, cm.W),
                       score=[float(mo.result.score), float(cm.result.score)],
                       frame=len(pts(mo.corner_ds) ^ pts(cm.corner_ds))
                       + len(pts(mo.surf_ds) ^ pts(cm.surf_ds)))
        out.append(row)
    return out


def feature_rings(fc):
    """Per feature class: (valid points, capacity, the rings it keeps)."""
    out = {}
    for name in FEATURE_CLASSES:
        c = getattr(fc, name)
        out[name] = (int(c.mask.sum()), c.capacity, sorted(set(c.ring[c.mask].tolist())))
    return out


def ring_spans(rings):
    """[0, 1, 2, 5, 6] -> '0-2, 5-6'."""
    spans, start = [], None
    for i, r in enumerate(rings):
        if start is None:
            start = r
        if i + 1 == len(rings) or rings[i + 1] != r + 1:
            spans.append(f"{start}-{r}" if r != start else f"{r}")
            start = None
    return ", ".join(spans) or "none"


def compare_features(pts, cfg, mapper, device):
    """One sweep's organized cells and features on the card against the
    CPU's.  The organizer must give the same cells, bit for bit.  The
    features may differ only where a cell's internals do: classify's label
    (an ulp of eig3's arccos / cos decides a threshold; phase 29), its
    scan status, or its side of the curvature threshold.  Such a moved cell
    can change the picks of its (ring, feature region).  So per compacted
    class, the points outside those regions must be the same points in the
    same ring-major order, bit for bit, but for a tail at most as long as
    the points inside them (a class at capacity shifts its cut by those);
    less_flat, voxel-filtered, by at most 4 points per moved cell (the
    bound of test_torch_features.py).  And the card's sharp and flat must
    hold exactly the first ``capacity`` cells of its own pick masks in
    ring-major order: the compaction at overflow.  Returns (feature_rings
    on the card and on the CPU, the moved cells, the problems found)."""
    from cooper_mapper_torch.models import scan_registration as sr
    from cooper_mapper_torch.ops import features

    thr = cfg.registration.surface_curvature_threshold
    got = {}
    for dev in (device, "cpu"):
        sw = sr.organize_unordered(pts, cfg.registration, mapper, device=dev)
        got[dev] = host_copy((sw, *features.extract_features_debug(sw, cfg.registration)))
    (swg, fcg, dg), (swc, fcc, dc) = got[device], got["cpu"]
    problems = []
    if not all(torch.equal(getattr(swg, f), getattr(swc, f)) for f in ("xyz", "mask", "rel_time")):
        problems.append("the organized sweeps differ")
    moved = ((dg.label != dc.label) | (dg.status != dc.status)
             | ((dg.curvature < thr) != (dc.curvature < thr))) & swc.mask
    n_moved = int(moved.sum())
    if n_moved > MOVED_SHARE * int(swc.mask.sum()):
        problems.append(f"{n_moved} cells' internals differ")
    rows, cols = torch.nonzero(swc.mask, as_tuple=True)
    cell_of = {tuple(x): (r, c) for x, r, c in zip(swc.xyz[rows, cols].tolist(), rows.tolist(),
                                                   cols.tolist())}
    region = dc.region_id
    hit = {(r, int(region[r, c])) for r, c in moved.nonzero().tolist()}
    inside = lambda p: (cell_of[p[0]][0], int(region[cell_of[p[0]]])) in hit
    kept = lambda c: list(zip(map(tuple, c.xyz[c.mask].tolist()), c.ring[c.mask].tolist(),
                              c.rel_time[c.mask].tolist()))
    for name in FEATURE_CLASSES:
        a, b = getattr(fcg, name), getattr(fcc, name)
        if n_moved == 0 and not all(torch.equal(getattr(a, f), getattr(b, f))
                                    for f in ("xyz", "mask", "ring", "rel_time")):
            problems.append(f"{name} differs with no cell moved")
        pa, pb = kept(a), kept(b)
        if name == "less_flat":
            if len(set(pa) ^ set(pb)) > 4 * n_moved:
                problems.append(f"less_flat differs by {len(set(pa) ^ set(pb))} points")
            continue
        fa, fb = [p for p in pa if not inside(p)], [p for p in pb if not inside(p)]
        n = min(len(fa), len(fb))
        if fa[:n] != fb[:n] or abs(len(fa) - len(fb)) > len(pa) + len(pb) - len(fa) - len(fb):
            problems.append(f"{name} differs outside the moved cells' regions")
    for name, picked in (("sharp", dg.sharp_picked), ("flat", dg.flat_picked)):
        c = getattr(fcg, name)
        n = int(c.mask.sum())
        want = (swg.xyz[picked][:c.capacity], torch.nonzero(picked)[:c.capacity, 0],
                swg.rel_time[picked][:c.capacity])
        if (n != len(want[0]) or not bool(c.mask[:n].all())
                or not all(torch.equal(x[:n], w.to(x.dtype))
                           for x, w in zip((c.xyz, c.ring, c.rel_time), want))):
            problems.append(f"the card's {name} is not the first {c.capacity} picked cells")
    return feature_rings(fcg), feature_rings(fcc), n_moved, problems


def offline_cpu_child(sweep_dir, out_dir, sensor, result, lockstep):
    """The CPU side of a phase 37 / 38 comparison (a subprocess): run() on
    the CPU over the first sweeps, then the card's recorded solves replayed
    (``lockstep_replay``).  The trajectory is saved to ``result``, the
    replay to ``result``.json."""
    torch.set_num_threads(OFFLINE_CPU_THREADS)
    from cooper_mapper_torch.examples import run_offline

    t0 = time.perf_counter()
    pipe = run_offline.run(sweep_dir, out_dir, sensor, "mapping", 2, device="cpu")
    np.save(result, np.stack(pipe.trajectory))
    del pipe
    t1 = time.perf_counter()
    rows = lockstep_replay(torch.load(lockstep, weights_only=False))
    with open(result + ".json", "w") as f:
        json.dump(dict(rows=rows, run_s=t1 - t0, replay_s=time.perf_counter() - t1), f)


def offline_phase(sensor, root, tally, device):
    """The offline runner (``examples/run_offline.run``, the port's) at a
    sensor preset at full width: its sweeps written as files
    (``run_offline.write_drive``), then run() as a user calls it, with the
    solves of the first sweeps recorded for the CPU's replay.  The CPU side
    starts later in the background (``offline_cpu_start``) and is checked
    by ``offline_cpu_check``."""
    import shutil

    from cooper_mapper_torch.examples import run_offline

    phase, label, n_rings, vfov = OFFLINE_SENSORS[sensor]
    preset, mapper = run_offline.SENSORS[sensor]
    cfg = preset()
    t0 = time.perf_counter()
    log(f"[{phase}] the offline runner at the {label} preset ({sensor}(): {n_rings} x "
        f"{cfg.registration.max_points_per_ring}, the default capacities and map): "
        f"{OFFLINE_SWEEPS} sweeps of {n_rings} x {OFFLINE_WIDTH} at vfov {vfov}, "
        f"{OFFLINE_STEP_M} m apart in a straight line in the selftest's room, written by "
        f"run_offline.write_drive; run(dir, out, sensor={sensor!r}, mode='mapping', stride=2, "
        f"device={device!r})")
    d = os.path.join(root, sensor)
    sweep_dir, cpu_dir = os.path.join(d, "sweeps"), os.path.join(d, "sweeps_cpu")
    written = run_offline.write_drive(sweep_dir, OFFLINE_SWEEPS, n_rings, OFFLINE_WIDTH, vfov,
                                      OFFLINE_STEP_M, device)
    os.makedirs(cpu_dir)
    for i in range(OFFLINE_CPU_SWEEPS):
        name = f"sweep_{i:04d}.npz"
        shutil.copy(os.path.join(sweep_dir, name), os.path.join(cpu_dir, name))
    log(f"    points per sweep written: {written}")
    # the first sweep's organizer and features on the card and on the CPU:
    # the capacity cut, and the compaction at overflow
    first = run_offline.load_sweep_file(os.path.join(sweep_dir, "sweep_0000.npz"))
    feats, feats_cpu, n_moved, problems = compare_features(first, cfg, mapper, device)
    for name, (n, cap, rings) in feats.items():
        log(f"    sweep 0 {name}: {n} of {cap} (CPU {feats_cpu[name][0]}), rings "
            f"{ring_spans(rings)} of 0-{n_rings - 1} (CPU {ring_spans(feats_cpu[name][2])})")
    log(f"    sweep 0 on the card vs the CPU: organized cells equal, {n_moved} of {len(first)} "
        f"cells' label / status / curvature side differ; every class the same points in the "
        f"same order outside those cells' regions, and the card's sharp and flat the first "
        f"cells of its picks: {not problems}")
    if problems:
        fail(f"phase {phase}: the first sweep on the card vs the CPU: {problems}")

    race, knn_per_solve = sweep_launches(cfg, device)
    # the organizer's host time per sweep (to the card included)
    organize, org_ms = run_offline.scan_registration.organize_unordered, []

    def timed_organize(*args, **kw):
        t1 = time.perf_counter()
        sw = organize(*args, **kw)
        torch.cuda.synchronize()
        org_ms.append((time.perf_counter() - t1) * 1e3)
        return sw

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_offline.scan_registration.organize_unordered = timed_organize
    try:
        with PipelineProbe(run_offline, capture=OFFLINE_CPU_SWEEPS) as probe:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                pipe = run_offline.run(sweep_dir, os.path.join(d, "out"), sensor, "mapping", 2,
                                       device=device)
    finally:
        run_offline.scan_registration.organize_unordered = organize
    # the run's own peak: above what earlier phases still hold
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    lockstep = os.path.join(d, "lockstep.pt")
    torch.save(probe.lockstep, lockstep)
    printed = buf.getvalue().strip().splitlines()
    log(f"    run() printed {len(printed)} lines; the last: {printed[-1][:300]}")
    traj = np.stack(pipe.trajectory)
    cells = [s["cells"] for s in probe.sweeps]
    bad = []
    for i, s in enumerate(probe.sweeps):
        want = (dict.fromkeys(s["launches"], 0) if i == 0 else
                dict(race, knn=knn_per_solve if s["solved"] is not None else 0))
        if s["launches"] != want:
            bad.append((i, s["launches"], want))
    probe.tally(tally)
    gt_end = np.array([0.0, 0.0, OFFLINE_STEP_M * (OFFLINE_SWEEPS - 1)])
    drift = traj[-1, :3, 3] - gt_end
    # the sweeps after those whose solves were recorded
    ms = [s["ms"] for s in probe.sweeps[OFFLINE_CPU_SWEEPS:]]
    maps = sorted(os.listdir(os.path.join(d, "out", "map")))
    log(f"    map solves (score, gate, frame features): {probe.solves}; stats {pipe.stats()}")
    log(f"    the smallest eigenvalue of JtJ at each solve's iteration 0, by the solve's "
        f"degeneracy threshold (10: odometry, 100: map): {probe.smallest_eigenvalues()}")
    log(f"    end position {traj[-1, :3, 3].round(4).tolist()} vs the straight ground truth "
        f"{gt_end.round(4).tolist()}: drift {float(np.linalg.norm(drift)):.4f} m (x "
        f"{drift[0]:+.4f}, height {drift[1]:+.4f}, along {drift[2]:+.4f}); every pose finite "
        f"{bool(np.isfinite(traj).all())}")
    log(f"    organized valid cells per sweep {cells} (points written: equal "
        f"{cells == written}); launches per odometry sweep {race}, k-NN {knn_per_solve} per "
        f"map solve: every sweep as expected {not bad}")
    log(f"    ms per sweep (best / median of sweeps {OFFLINE_CPU_SWEEPS}..{OFFLINE_SWEEPS - 1}): "
        f"{ms_stat(ms)}; organize_unordered on the host {ms_brief(org_ms[1:])} ms per sweep "
        f"(outside process()); the run's peak memory {peak:.1f} MiB above the "
        f"{base / 2**20:.1f} MiB held before it; map files {len(maps)}")
    log("    StageTimer report (sweeps 1-3 copy their solves' inputs on the card: a few "
        "small clones):\n"
        + "\n".join("      " + ln for ln in pipe.timer.report().split("\n")))
    if not np.isfinite(traj).all():
        fail(f"phase {phase}: a pose is not finite")
    if cells != written:
        fail(f"phase {phase}: the organizer's valid cells {cells} differ from the points "
             f"written {written}")
    if bad:
        fail(f"phase {phase}: sweeps launched other than expected (sweep, got, want): {bad}")
    if "index.txt" not in maps or len(maps) < 2:
        fail(f"phase {phase}: the map's cube files were not written: {maps}")
    seconds = time.perf_counter() - t0
    log(f"    phase {phase}: {seconds:.1f} s")
    stages = {k: stage_ms(pipe.timer, k) for k in pipe.timer.calls}
    return dict(trajectory=traj, sweep_dir=cpu_dir, dir=d, lockstep=lockstep, feats=feats,
                ms=ms, org_ms=float(np.median(org_ms[1:])),
                peak=peak, drift=float(np.linalg.norm(drift)), height=float(drift[1]),
                solves=probe.solves, stages=stages, seconds=seconds)


def offline_cpu_start(sensor, run):
    """Start phase 37 / 38's CPU side in a subprocess."""
    res = os.path.join(run["dir"], "cpu.npy")
    log_path = os.path.join(run["dir"], "cpu.log")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.offline_cpu_child({run['sweep_dir']!r}, "
            f"{os.path.join(run['dir'], 'out_cpu')!r}, {sensor!r}, {res!r}, "
            f"{run['lockstep']!r})")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                stderr=subprocess.STDOUT, cwd=ROOT)
    return dict(proc=proc, result=res, log=log_path, t0=time.perf_counter())


def offline_cpu_check(sensor, run, child):
    """Phase 37 / 38's CPU comparison.  The replay: every solve of sweeps
    1-3 from the card's own state within CPU_TOL (phase 17's bound) of the
    card's.  The free run: the first sweeps' poses within the sensor's
    OFFLINE_FREE_TOL of the CPU run's."""
    phase, label, _, _ = OFFLINE_SENSORS[sensor]
    try:
        rc = child["proc"].wait(timeout=max(1.0, OFFLINE_CPU_TIMEOUT
                                            - (time.perf_counter() - child["t0"])))
    except subprocess.TimeoutExpired:
        child["proc"].kill()
        child["proc"].wait()
        fail(f"phase {phase}: the CPU run outlived {OFFLINE_CPU_TIMEOUT} s")
    seconds = time.perf_counter() - child["t0"]
    if rc != 0:
        with open(child["log"]) as f:
            fail(f"phase {phase}: the CPU run failed (rc {rc}): {f.read()[-3000:]}")
    cpu = np.load(child["result"])
    with open(child["result"] + ".json") as f:
        replay = json.load(f)
    rows = replay["rows"]
    dx = np.abs(run["trajectory"][:len(cpu)] - cpu).max(axis=(1, 2))
    tol = OFFLINE_FREE_TOL[sensor]
    # a solve's bound: CPU_TOL, or twice what a one-ulp move of its inputs
    # does to the CPU's own pose where that is more (two samples of a spread)
    over = [r["sweep"] for r in rows
            if r["odo"] > max(CPU_TOL, 2 * (r["odo_ulp"] or 0.0))
            or r.get("map", 0.0) > CPU_TOL]
    log(f"[{phase}] {label} card vs CPU over the first {len(cpu)} files ({OFFLINE_CPU_THREADS} "
        f"threads, {seconds:.1f} s in the background: the run {replay['run_s']:.1f} s, the "
        f"replay {replay['replay_s']:.1f} s).  Each solve of sweeps 1-3 replayed on the CPU "
        f"from the card's state and inputs (odometry: max |dT|, the CPU's own move under "
        f"one-ulp moves of the inputs where max |dT| > {CPU_TOL}, matched card / CPU, max "
        f"|dxyz| of the projected "
        f"clouds; map: max |dW|, scores, frame points differing): {rows}; odometry gated at "
        f"max({CPU_TOL}, 2 x odo_ulp), map at {CPU_TOL}.  The free run, max |dW| per sweep "
        f"{dx.round(6).tolist()}; gated at {tol}")
    if len(cpu) != OFFLINE_CPU_SWEEPS or len(rows) != OFFLINE_CPU_SWEEPS - 1:
        fail(f"phase {phase}: the CPU side covered {len(cpu)} sweeps and replayed {len(rows)}")
    if over:
        fail(f"phase {phase}: the solves of sweeps {over} on the card part from the same "
             f"solves on the CPU beyond their bound")
    if any(dx[i] > t for i, t in enumerate(tol)):
        fail(f"phase {phase}: the card's and the CPU's runs of the first sweeps disagree")
    return dict(dx=dx.tolist(), local=max(max(r["odo"], r.get("map", 0.0)) for r in rows))


def stop_children(children):
    """Kill the CPU runs still going."""
    for child in children:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()


# the demos' defaults (the JAX scripts'): demo_mapping's sweeps, demo_wander's steps
DEMO_MAPPING_SWEEPS, DEMO_WANDER_STEPS = 20, 15


def scripts_phase(root, tally, device):
    """The port's scripts as a user runs them: ``python -m
    cooper_mapper_torch.examples.run_offline --selftest`` in a subprocess
    (the JAX selftest's own gate), then each demo's main() on the card at
    the JAX script's defaults: every pose finite, the ATEs printed."""
    from cooper_mapper_torch.examples import (demo_graph_slam, demo_localization, demo_mapping,
                                              demo_wander)

    t0 = time.perf_counter()
    log("[39] the port's scripts: python -m cooper_mapper_torch.examples.run_offline --selftest "
        "(a subprocess), then demo_mapping, demo_localization, demo_graph_slam and demo_wander "
        f"main() on {device} at their defaults")
    res = subprocess.run([sys.executable, "-m", "cooper_mapper_torch.examples.run_offline",
                          "--selftest"], capture_output=True, text=True, cwd=ROOT,
                         timeout=SELFTEST_TIMEOUT)
    selftest_s = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    drift = [ln for ln in lines if "drift" in ln]
    log(f"    --selftest: rc {res.returncode} in {selftest_s:.1f} s; {drift}; last line "
        f"{lines[-1] if lines else None!r}")
    if res.returncode != 0 or not lines or lines[-1] != "SELFTEST OK":
        fail(f"phase 39: run_offline --selftest failed: {res.stdout[-2000:]} {res.stderr[-3000:]}")

    demos = {
        "demo_mapping": (demo_mapping, lambda: demo_mapping.main(
            DEMO_MAPPING_SWEEPS, os.path.join(root, "demo_map"), device=device),
            ("ATE rmse",)),
        "demo_localization": (demo_localization, lambda: demo_localization.main(
            os.path.join(root, "demo_loc_map"), device=device),
            ("mapping done", "mean localization error")),
        "demo_graph_slam": (demo_graph_slam, lambda: demo_graph_slam.main(
            os.path.join(root, "demo_graph"), device=device),
            ("sweeps:", "ATE rmse", "keyframe ATE", "end-pose")),
        "demo_wander": (demo_wander, lambda: demo_wander.main(DEMO_WANDER_STEPS, device=device),
                        ("wander ATE",)),
    }
    out = {"selftest_s": selftest_s, "selftest": drift}
    for name, (module, call, keys) in demos.items():
        t1 = time.perf_counter()
        buf = io.StringIO()
        with PipelineProbe(module) as probe, contextlib.redirect_stdout(buf):
            call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        probe.tally(tally)
        printed = buf.getvalue().strip().splitlines()
        shown = [ln.strip() for ln in printed if ln.strip().startswith(keys)]
        finite = all(np.isfinite(np.stack(p.trajectory)).all() for p in probe.pipes)
        n = sum(len(p.trajectory) for p in probe.pipes)
        log(f"    {name}: {seconds:.1f} s, {len(probe.pipes)} pipelines, {n} sweeps, every pose "
            f"finite {finite}, map solves {len(probe.solves)}; {shown}")
        if not finite or n == 0:
            fail(f"phase 39: {name} gave a non-finite pose")
        out[name] = dict(seconds=seconds, shown=shown)
    out["seconds"] = time.perf_counter() - t0
    log(f"    phase 39: {out['seconds']:.1f} s")
    return out


# Phase 41: the port's reach against the JAX package's.  The k-NN at every k
# the TPU kernel takes (its k is static, any 1 <= k <= M): the register
# lists up to 32, the select route above; every search kernel at more than
# 65,535 problems (the JAX package's vmap runs any batch).
COVER_KS = tuple(range(1, 33)) + (33, 63, 64, 65, 100, 127, 128, 257, 1000, 1024, 1025)
COVER_TIMED_KS = (8, 16, 32, 33, 64, 100, 257)
# the select route's device ms before its redesign (a block per query, radix
# select then sort; PERF.md section 6), beside this run's: 64 x 2048 vs 5888
# at k = 33 / 64 / 100 / 257, and 1 x 8192 vs 65536 over k = 33..257
RADIX_DEVICE_MS = {"scan-to-map surf": {33: 5.6597, 64: 5.7687, 100: 6.1241, 257: 7.8328},
                   "split B=1": {k: "8.0070-8.2706" for k in (33, 64, 100, 257)}}
# merge_first_k's device ms per launch before its redesign (a thread per
# query), by S at k = 5: inside the mapping sweep's k-NN at n = 2048, S = 66
# and n = 8192, S = 17 (time_search_kernels.py's merge_first_k kind, PERF.md
# section 6)
SERIAL_MERGE_DEVICE_MS = {66: 0.0166, 17: 0.0059}
WIDE_B = 65537                      # one problem past CUDA's grid-y cap
WIDE_Q, WIDE_M, WIDE_M_PER = 128, 512, 64
WIDE_KNN_KS = (5, 40)               # a register-list k and a select-route k
# batch_odometry_solve at WIDE_B: its first BATCH rows against the BATCH
# solve of the same rows.  The lanes are independent, but the eager GN's
# reductions may take other reduction plans at another batch size: held to
# tests/test_sharded_map.py's sharded-vs-unsharded odometry tolerance.
WIDE_ODO_TOL = 1e-4
CLASSIFY_KS = (8, 40)               # tests/test_io.py's k; a select-route k
LABEL_MARGIN = 1e-4                 # tests/test_torch_feature_extracter.py's MARGIN


def tie_heavy(device, B=2, Q=300, M=1300, seed=5):
    """Integer-grid points, seven values per axis: most distances repeat."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randint(-3, 4, (B, Q, 3)).astype(np.float32)).to(device)
    r = torch.from_numpy(rng.randint(-3, 4, (M, 3)).astype(np.float32)).to(device)
    return q, r, torch.from_numpy(rng.rand(M) > 0.1).to(device)


def every_k_check(cases):
    """``knn.knn`` against ``knn_plain`` at every k of COVER_KS on each case,
    bit for bit (indices and distances); every route.  A case's k_equals_m
    adds k = M."""
    from cooper_mapper_torch.ops import knn

    for label, q, r, m, *k_equals_m in cases:
        bad = []
        for k in COVER_KS + ((r.shape[-2],) if k_equals_m else ()):
            if k > r.shape[-2]:
                continue
            got = knn.knn(q, r, m, k)
            want = knn.knn_plain(q, r, m, k)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                bad.append(k)
        torch.cuda.synchronize()
        log(f"    knn {label} {tuple(q.shape)} vs {tuple(r.shape)}: k = 1..32, "
            f"{', '.join(map(str, COVER_KS[32:]))}{' and M' if k_equals_m else ''} against "
            f"knn_plain, bit for bit: {'all equal' if not bad else bad}")
        if bad:
            fail(f"knn {label} disagrees with knn_plain at k = {bad}")


def wide_batch_check(device):
    """Every race kernel and both k-NN routes at B = WIDE_B problems, a
    shared reference and a per-problem one, bit for bit with their plain
    versions; the wrapper's ms per call.  Returns {kernel: row}."""
    from cooper_mapper_torch.ops import knn, neighbors, races

    rng = np.random.RandomState(41)
    B, Q = WIDE_B, WIDE_Q
    q = torch.from_numpy(rng.uniform(-8, 8, (B, Q, 3)).astype(np.float32)).to(device)
    refs = {}
    for label, lead, M in (("shared", (), WIDE_M), ("per-problem", (B,), WIDE_M_PER)):
        xyz = torch.from_numpy(rng.uniform(-8, 8, lead + (M, 3)).astype(np.float32)).to(device)
        ring = torch.from_numpy(rng.randint(0, 16, lead + (M,)).astype(np.int32)).to(device)
        mask = torch.from_numpy(rng.rand(*(lead + (M,))) > 0.1).to(device)
        refs[label] = (xyz, ring, mask)
    rows = {}
    for label, (xyz, ring, mask) in refs.items():
        shared = xyz.dim() == 2
        ia, _ = races.nn1_plain(q, xyz, mask)
        ring_a = neighbors.take_ref(ring, ia, shared)
        calls = {
            "nn1": (lambda: races.nn1(q, xyz, mask), lambda: races.nn1_plain(q, xyz, mask)),
            **{f"nn1_masked {mode}": (
                lambda mode=mode: races.nn1_masked(q, ring_a, ia, xyz, ring, mask, mode),
                lambda mode=mode: races.nn1_masked_plain(q, ring_a, ia, xyz, ring, mask, mode))
               for mode in ("adj", "same")},
            "bc_races": (lambda: races.bc_races(q, ring_a, ia, xyz, ring, mask),
                         lambda: races.bc_races_plain(q, ring_a, ia, xyz, ring, mask)),
            **{f"fused_races {'surf' if ws else 'corner'}": (
                lambda ws=ws: races.fused_races(q, xyz, ring, mask, ws),
                lambda ws=ws: races.fused_races_plain(q, xyz, ring, mask, ws))
               for ws in (True, False)},
            **{f"knn k={k}": (lambda k=k: knn.knn(q, xyz, mask, k),
                              lambda k=k: knn.knn_plain(q, xyz, mask, k))
               for k in WIDE_KNN_KS},
        }
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = time_ms(kern, reps=3, warmup=1)
            plain_ms = time_ms(plain, reps=1, warmup=0)
            log(f"    {name} at B={B}, {Q} queries vs {label} M={xyz.shape[-2]}: "
                f"{'equal' if same else 'DIFFERENT'}; kernel {ms:.3f} ms, plain "
                f"{plain_ms:.2f} ms per call")
            if not same:
                fail(f"{name} at B={B} ({label} reference) disagrees with its plain version")
            rows.setdefault(name, []).append(dict(shape=f"{B}x{Q} vs {label} {xyz.shape[-2]}",
                                                  ms=ms, plain_ms=plain_ms))
    return rows


def wide_odometry(bench, device):
    """batch_odometry_solve at B = WIDE_B on the bench pair: its first
    BATCH rows against the BATCH solve of the same rows; solves/s."""
    from cooper_mapper_torch.config import OdometryConfig
    from cooper_mapper_torch.ops import odometry

    sharp1, flat1, ref_c, ref_s = bench
    cfg = OdometryConfig()
    x0 = torch.from_numpy((0.02 * np.random.RandomState(0).randn(WIDE_B, 6))
                          .astype(np.float32)).to(device)
    sharp, flat = tile(sharp1, WIDE_B), tile(flat1, WIDE_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, st = odometry.batch_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del sharp, flat, st
    x_small, _ = odometry.batch_odometry_solve(tile(sharp1, BATCH), tile(flat1, BATCH), ref_c,
                                               ref_s, x0[:BATCH], cfg)
    dx = float((x[:BATCH] - x_small).abs().max())
    finite = bool(torch.isfinite(x).all())
    log(f"    batch_odometry_solve at B={WIDE_B}: {seconds:.2f} s, {WIDE_B / seconds:.1f} "
        f"solves/s; rows 0..{BATCH - 1} against the B={BATCH} solve: max |dx| {dx:.3g} "
        f"(tolerance {WIDE_ODO_TOL}); all lanes finite {finite}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (finite and dx <= WIDE_ODO_TOL):
        fail(f"batch_odometry_solve at B={WIDE_B} disagrees with the B={BATCH} solve")
    return dict(seconds=seconds, sps=WIDE_B / seconds, dx=dx)


def knn8_scan_match(scan, device):
    """batch_scan_match at ScanMatchConfig(knn=8), B = SM_BATCH on the
    scan-to-map problem; lanes 0..CPU_LANES-1 against the CPU."""
    from cooper_mapper_torch.config import ScanMatchConfig
    from cooper_mapper_torch.ops import scan_match as sm

    corner, surf, ref_c, ref_s, x0 = scan
    cfg = ScanMatchConfig(knn=8)
    corner_b, surf_b = tile(corner, SM_BATCH), tile(surf, SM_BATCH)
    res = sm.batch_scan_match(corner_b, surf_b, ref_c, ref_s, x0, cfg)
    res_cpu = sm.batch_scan_match(to_cpu(corner_b, CPU_LANES), to_cpu(surf_b, CPU_LANES),
                                  to_cpu(ref_c), to_cpu(ref_s), x0[:CPU_LANES].cpu(), cfg)
    dx = float((res.x[:CPU_LANES].cpu() - res_cpu.x).abs().max())
    same_ok = res.success[:CPU_LANES].cpu().tolist() == res_cpu.success.tolist()
    log(f"    batch_scan_match knn=8 at B={SM_BATCH}: success {int(res.success.sum())} of "
        f"{SM_BATCH}, lanes 0..{CPU_LANES - 1} vs the CPU max |dx| {dx:.3g} (tolerance "
        f"{CPU_TOL}), success the same {same_ok}")
    if not (torch.isfinite(res.x).all() and dx <= CPU_TOL and same_ok):
        fail("batch_scan_match at knn=8: card and CPU disagree")
    return dx


def classify_scene():
    """tests/test_io.py::TestFeatureExtracter's cloud: a plane patch and a line."""
    rng = np.random.RandomState(0)
    uv = rng.uniform(-2, 2, (400, 2))
    plane = np.stack([uv[:, 0], np.zeros(400), uv[:, 1]], -1)
    t = rng.uniform(-2, 2, (100, 1))
    line = np.concatenate([t * 0 + 5.0, t * 3, t * 0], -1)
    return np.concatenate([plane, line]).astype(np.float32)


def classify_check(device):
    """classify_map_points on the card against the CPU at CLASSIFY_KS:
    labels equal but where the CPU's eigenvalues lie within LABEL_MARGIN of
    a threshold; the test's own gates at k = 8."""
    from cooper_mapper_torch.io import feature_extracter as fe

    xyz = classify_scene()
    pts = torch.from_numpy(xyz)
    out = {}
    for k in CLASSIFY_KS:
        card = fe.classify_map_points(xyz, k=k, device=device)
        cpu = fe.classify_map_points(xyz, k=k, device="cpu")
        differ = (card[0] != cpu[0]) | (card[1] != cpu[1])
        margin = fe.threshold_margin(fe.eigenvalues(pts, fe.neighbours(pts, k))).numpy()
        ok = bool(np.all(margin[differ] < LABEL_MARGIN))
        log(f"    classify_map_points k={k}: surf {int(card[0].sum())}, corner "
            f"{int(card[1].sum())} of {len(xyz)}; labels differing from the CPU "
            f"{int(differ.sum())} (all within {LABEL_MARGIN} of a threshold: {ok})")
        if not ok:
            fail(f"classify_map_points(k={k}) on the card disagrees with the CPU")
        if k == 8 and not (card[0][:400].mean() > 0.8 and card[1][400:].mean() > 0.6
                           and card[1][:400].mean() < 0.2):
            fail("classify_map_points(k=8) on the card misses tests/test_io.py's gates")
        out[k] = int(differ.sum())
    return out


def knn_chunk_lists(q, ref, S, k):
    """The chunk lists [S, n, k] that the k-NN split into S chunks writes
    before merge_first_k (B = 1, shared reference): knn_plain over each
    chunk, indices offset, a chunk of fewer than k points ending in (+inf,
    0), (+inf, 1), ... as the kernel's list starts."""
    from cooper_mapper_torch.ops import knn

    M = ref.xyz.shape[0]
    L = -(-M // S)
    pd = torch.full((S, q.shape[1], k), float("inf"), device=q.device)
    pi = torch.zeros((S, q.shape[1], k), dtype=torch.int32, device=q.device)
    for z in range(S):
        a, b = z * L, min(M, (z + 1) * L)
        kk = min(k, b - a)
        i, d = knn.knn_plain(q, ref.xyz[a:b].contiguous(), ref.mask[a:b].contiguous(), kk)
        pd[z, :, :kk], pi[z, :, :kk] = d[0], i[0] + a
        pi[z, :, kk:] = torch.arange(k - kk, dtype=torch.int32, device=q.device)
    return pd, pi


def merge_first_k_check(split_inputs, k=KNN_K):
    """merge_first_k against merge_first_k_plain and the one scan, bit for
    bit, on the chunk lists of the B = 1 sweep searches as their plan splits
    them; its times.  Returns the kernels-line rows, S = 66 first."""
    from cooper_mapper_torch.ops import knn, races

    rows = []
    for tag in ("corner", "surf"):
        q, _, ref = split_inputs[tag]
        n, M = q.shape[1], ref.xyz.shape[0]
        S = races._split_plan(1, n, M, races.sm_count(q.device), knn_block_queries(k))[0]
        pd, pi = knn_chunk_lists(q, ref, S, k)
        got = knn.merge_first_k(pd, pi)
        err = compare_exact(f"merge_first_k S={S} n={n} k={k} vs merge_first_k_plain", got,
                            knn.merge_first_k_plain(pd, pi))
        one = knn.knn_plain(q, ref.xyz, ref.mask, k)
        compare_exact(f"merge_first_k S={S} n={n} k={k} vs the one scan", got,
                      (one[0][0], one[1][0]))
        call = lambda: knn.merge_first_k(pd, pi)
        cand = pd.permute(1, 0, 2).reshape(n, S * k)
        row = dict(shape=f"{S}x{n}x{k}", S=S, err=err, ms=time_ms(call, reps=20),
                   device_ms=device_ms(call, ("merge_first_k",))[0],
                   plain_ms=time_ms(lambda: knn.merge_first_k_plain(pd, pi), reps=3, warmup=1),
                   library_ms=time_ms(lambda: cand.topk(k, largest=False), reps=3, warmup=1),
                   bound_ms=(S * n * k * 8 + n * k * 8) / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        log(f"    merge_first_k S={S} n={n} k={k}: kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}; the thread-per-query design's "
            f"{SERIAL_MERGE_DEVICE_MS.get(S, 'not measured')}), "
            f"plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms (bytes)")
        rows.append(row)
    return rows


def coverage_phase(scan, split_inputs, bench, device):
    """[41] The port's reach against the JAX package's: the k-NN at every k
    on both routes, bit for bit, and its times; every search kernel at
    B = WIDE_B, bit for bit; then the main paths there, counted:
    batch_odometry_solve at B = WIDE_B, batch_scan_match at knn=8 and
    classify_map_points at k = 8 and 40.  Returns the phase's numbers."""
    from cooper_mapper_torch.utils import twist
    from cooper_mapper_torch.utils.profiling import COUNTS

    t_start = time.perf_counter()
    corner, surf, map_c, map_s, x0_sm = scan
    qs = twist.point_to_map(x0_sm, surf.xyz).contiguous()
    q1, _, ref1 = split_inputs["surf"]
    nb = 8
    ref_sb = tile(map_s, nb)
    log("[41] coverage: the k-NN at every k (register lists k <= 32, the select routes "
        "above), its merge, every search kernel at B = 65,537, and their main paths")
    every_k_check([("scan-to-map surf", qs, map_s.xyz, map_s.mask),
                   ("per-problem map", qs[:nb].contiguous(), ref_sb.xyz, ref_sb.mask),
                   ("split B=1 (mapping sweep 4's surf)", q1, ref1.xyz, ref1.mask),
                   ("tie-heavy integer grid", *tie_heavy(device), True)])
    log(f"    times at k = {COVER_TIMED_KS} ({KNN_TIMES}, topk(k))")
    names = ("knn_kernel", "merge_first_k", "knn_select_kernel")
    timed = {tag: [knn_times(tag, q, ref, 0.0, k=k, reps=10, device_names=names)
                   for k in COVER_TIMED_KS]
             for tag, q, ref in (("scan-to-map surf", qs, map_s), ("split B=1", q1, ref1))}
    for tag, rows in timed.items():
        log(f"    select route device ms at {tag}, this run against the radix design's: "
            + "; ".join(f"k={v['k']} {fmt_ms(v['device_ms'])} ({RADIX_DEVICE_MS[tag][v['k']]})"
                        for v in rows if v["k"] > 32))
    merges = merge_first_k_check(split_inputs)
    wide = wide_batch_check(device)

    log("    main paths at the new reach, every launch counter at 0 first")
    reset_launches()
    COUNTS["knn.knn_select.launches"] = 0
    odo = wide_odometry(bench, device)
    sm_dx = knn8_scan_match(scan, device)
    labels = classify_check(device)
    torch.cuda.synchronize()
    launches = dict(read_launches(), knn_select=COUNTS["knn.knn_select.launches"])
    log(f"    launches in phase 41's main paths: {launches}")
    for k in ("nn1", "nn1_masked", "bc_races", "knn", "knn_select"):
        if launches[k] <= 0:
            fail(f"phase 41's main paths launched no {k}")
    seconds = time.perf_counter() - t_start
    log(f"    phase 41 {seconds:.1f} s")
    return dict(timed=timed, merge_rows=merges, wide=wide, odo=odo, sm_dx=sm_dx, labels=labels,
                launches=launches, merges=read_merges(), seconds=seconds)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device (this script runs on the card only)")
    import cooper_mapper_torch  # noqa: F401  (TF32 off)

    os.environ["COOPER_PALLAS_FUSED"] = "0"      # the default route, whatever the caller set
    device = "cuda"
    name, smi = card_line()
    build_s = build_phase()

    log("[3] sim -> features -> compacted clouds on the card")
    sharp1, flat1, ref_c, ref_s, motion = make_problem(device)
    log(f"    sharp {tuple(sharp1.xyz.shape)}, flat {tuple(flat1.xyz.shape)}, "
        f"less_sharp {tuple(ref_c.xyz.shape)}, less_flat {tuple(ref_s.xyz.shape)}")
    sharp, flat = tile(sharp1, BATCH), tile(flat1, BATCH)
    x0 = torch.from_numpy((0.02 * np.random.RandomState(0).randn(BATCH, 6))
                          .astype(np.float32)).to(device)
    kern = kernel_phase(sharp, flat, ref_c, ref_s, x0)
    launches, merges, sps_best, sps_med, solved4 = solve_phase(sharp, flat, ref_c, ref_s, x0,
                                                               motion)

    log("[6] scan-to-map problem (bench_scan_match.build_problem, ported) on the card")
    corner, surf, map_c, map_s = make_scan_match_problem(device)
    log(f"    frame corner {tuple(corner.xyz.shape)} ({int(corner.mask.sum())} valid), "
        f"surf {tuple(surf.xyz.shape)} ({int(surf.mask.sum())}); map corner "
        f"{tuple(map_c.xyz.shape)} ({int(map_c.mask.sum())}), surf {tuple(map_s.xyz.shape)} "
        f"({int(map_s.mask.sum())})")
    x0_sm = torch.from_numpy((0.02 * np.random.RandomState(0).randn(SM_BATCH, 6))
                             .astype(np.float32)).to(device)
    knn_rows = knn_kernel_phase(corner, surf, map_c, map_s, x0_sm)
    sm_launches, sm_merges, sm_best, sm_med, res7 = scan_match_phase(corner, surf, map_c, map_s,
                                                                     x0_sm)
    launches["knn"], merges["knn"] = sm_launches["knn"], sm_merges["knn"]
    kern["knn"] = knn_rows["surf"]

    ss_cfg, sweeps, truth, ss_clouds = make_stream(device)
    fused_rows = fused_kernel_phase(ss_clouds, (sharp.xyz, flat.xyz, ref_c, ref_s))
    runs, frame = stream_phase(ss_cfg, sweeps, truth, device)
    launches["fused_races"] = runs["fused"]["launches"]["fused_races"]
    ss_launches = runs["split"]["launches"]
    ss_stats = {r: dict(stat=v["stat"]) for r, v in runs.items()}
    kern["fused_races"] = fused_rows["single-stream surf"]
    launches["merge_min"] = runs["split"]["launches"]["merge_min"]
    merge_rows = [v for k, v in fused_rows.items() if k.startswith("merge ")]
    kern["merge_min"] = merge_rows[0]
    # the B = 1 shapes of the split route, where the kernels split M
    split_knn = {}
    single_stream = {"nn1": [fused_rows["nn1 single-stream surf"],
                             fused_rows["nn1 single-stream corner"]],
                     "nn1_masked": [fused_rows["nn1_masked single-stream"]],
                     "bc_races": [fused_rows["bc_races single-stream"]],
                     "knn": list(mapping_knn_phase(ss_cfg, sweeps, device,
                                                   keep=split_knn).values())}
    # the main path's other shapes of a kernel (nn1: the corner search; the
    # fused kernel: the drive's corner search and the bench's two; merge_min:
    # the other chunkings)
    more_shapes = {"nn1": [kern.pop("nn1 corner")],
                   "fused_races": [fused_rows[k] for k in ("single-stream corner", "bench surf",
                                                           "bench corner")],
                   "merge_min": merge_rows[1:]}
    loc_steady, loc_seed = localization_phase(runs["split"]["state"].map, frame, ss_cfg, device)
    del runs
    reduced_dx = reduced_card_vs_cpu_phase(device)
    pipe, pipe_run = pipeline_phase(sweeps, truth, device)
    pipe_loc = pipeline_localization_phase(pipe.single_map_state(), truth, device)
    pipe13 = dict(trajectory=np.stack(pipe.trajectory), map=pipe.single_map_state())
    del pipe
    local_run = local_phase(sweeps, truth, device)
    quick = quick_start_phase(device)
    reduced_pipe_dx = reduced_pipeline_card_vs_cpu_phase(device)
    pg_run = pose_graph_phase(device)
    pg_cpu_dx = pose_graph_card_vs_cpu_phase(device)
    gpipe, gdrive = graph_pipeline_phase(device)
    icp_run = icp_phase(gpipe, device)
    save_run = graph_save_phase(gpipe, gdrive, device)
    del gpipe
    graph_dx = graph_card_vs_cpu_phase(device)
    # the parity modes; every launch of their solves is tallied under "parity"
    parity = {}
    golden = golden_odometry_phase((sharp1, flat1, ref_c, ref_s), parity, device)
    parity_sps = parity_solve_phase(sharp, flat, ref_c, ref_s, x0, motion, parity)
    parity_drive = parity_drive_phase(ss_cfg, sweeps, truth, parity, device)
    sm_parity = scan_match_parity_phase(corner, surf, map_c, map_s, x0_sm, parity, device)
    passes2 = dewarp_passes_phase(quick, device)
    debug_differ = features_debug_phase(device)
    # the out-of-core map, the converter and the host I/O; every launch of
    # their main paths is tallied under "host_io"
    host_io = {}
    corridor = corridor_phase(host_io, device)
    convert = convert_phase(quick, host_io, device)
    del quick["sweeps"]
    bag = bag_phase(sweeps, truth, host_io, device)
    traced = trace_phase(host_io, device)
    # the parallel layer; every launch of its main paths, the two ranks' of
    # phase 36 included, is tallied under "parallel"
    par = {}
    one = one_rank_phase((sharp, flat, ref_c, ref_s, x0, *solved4, (sps_best, sps_med)),
                         (tile(corner, SM_BATCH), tile(surf, SM_BATCH), map_c, map_s, x0_sm,
                          res7, (sm_best, sm_med)),
                         pg_run, pipe13, sweeps, par, device)
    bucketed = bucketed_phase(sharp1, flat1, ref_c, ref_s, x0, par)
    two = two_rank_phase((sharp, flat, ref_c, ref_s, x0), one, pipe13, sweeps, truth, par,
                         device)
    # the entry scripts; every launch of their drives in this process is
    # tallied under "scripts" (the --selftest subprocess's are its own)
    import tempfile

    scripts, children = {}, {}
    t37 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        try:
            offline = {s: offline_phase(s, root, scripts, device) for s in OFFLINE_SENSORS}
            # the CPU runs of the first sweeps, beside phase 39
            children = {s: offline_cpu_start(s, offline[s]) for s in OFFLINE_SENSORS}
            script_run = scripts_phase(root, scripts, device)
            # phase 41 on the card while the CPU runs finish
            t41 = time.perf_counter()
            cover = coverage_phase((corner, surf, map_c, map_s, x0_sm), split_knn,
                                   (sharp1, flat1, ref_c, ref_s), device)
            t41 = time.perf_counter() - t41
            for s in OFFLINE_SENSORS:
                offline[s]["cpu"] = offline_cpu_check(s, offline[s], children[s])
        finally:
            stop_children(children.values())
    scripts_s = time.perf_counter() - t37 - t41

    sources = {"nn1": ("cooper_mapper_tpu/ops/pallas/nn1.py:69", "races.cu"),
               "nn1_masked": ("cooper_mapper_tpu/ops/pallas/nn1.py:173", "races.cu"),
               "bc_races": ("cooper_mapper_tpu/ops/pallas/nn1.py:301", "races.cu"),
               "fused_races": ("cooper_mapper_tpu/ops/pallas/nn1.py:416", "races.cu"),
               # no TPU counterpart: the merge of the split searches of nn1.py:69, :173, :301
               "merge_min": ("cooper_mapper_tpu/ops/pallas/nn1.py:69", "split.cuh"),
               "knn": ("cooper_mapper_tpu/ops/pallas/knn_stream.py:187", "knn.cu")}
    extra = ("k", "valid_ref", "valid_queries", "walk", "device_ms", "plan",
             "split_route_device_ms", "merges", "where")
    # the loop closure's shapes (phase 21): nn1 in ICP, the k-NN in the fine match
    more_shapes["nn1"].append(icp_run["nn1"])
    more_shapes["knn"] = [icp_run["knn"], convert["row"]]
    fields = lambda v: {"max_abs_err": v["err"], "ms": v["ms"], "plain_ms": v["plain_ms"],
                        "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                        "library_ms": v["library_ms"], "shape": v["shape"],
                        **{k: v[k] for k in extra if k in v}}
    rows = [{
        "name": k, "route": "cuda", "source": f"cooper_mapper_torch/csrc/{sources[k][1]}",
        "replaces": sources[k][0], "launches": launches[k], **fields(v),
    } for k, v in kern.items()]
    for row in rows:
        if row["name"] in more_shapes:
            row["more_shapes"] = [fields(v) for v in more_shapes[row["name"]]]
        if row["name"] in merges:
            # of the launches, the calls that split M and launched the merge kernel too
            row["merges"] = merges[row["name"]]
        # the SlamPipeline drive of phase 13 (mapping with IMU, split route)
        row["pipeline"] = dict(launches=pipe_run["launches"][row["name"]],
                               merges=pipe_run["launches"]["merges"].get(row["name"], 0))
        # inside the graph stage of the loop drive (phase 20): ICP, the fine match
        row["graph"] = dict(launches=gdrive["launches"][row["name"]],
                            merges=gdrive["merges"].get(row["name"], 0))
        # the parity phases' solves (24-27)
        row["parity"] = parity[row["name"]]
        # the out-of-core map, the converter, the bag replay and the trace (30-33)
        row["host_io"] = host_io[row["name"]]
        # the parallel layer (34-36): the mesh of one, the buckets, both ranks of 36
        row["parallel"] = par.get(row["name"], {"launches": 0, "merges": 0})
        # the entry scripts (37-39): run() at HDL-64E and HDL-32, the four demos
        row["scripts"] = scripts.get(row["name"], {"launches": 0, "merges": 0})
        if row["name"] in single_stream:
            # launches: the single-stream drive's on the split route
            row["single_stream"] = [dict(fields(v), launches=ss_launches[row["name"]],
                                         merges=ss_launches["merges"][row["name"]])
                                    for v in single_stream[row["name"]]]
    # phase 41: the k-NN at every k and every kernel at B = WIDE_B; the
    # select route's own row (its launches are phase 41's main paths')
    wide_of = lambda name: [dict(v, kernel=k) for k, rs in cover["wide"].items()
                            for v in rs if k.split(" ")[0] == name and k != "knn k=40"]
    for row in rows:
        row["coverage"] = dict(launches=cover["launches"][row["name"]],
                               merges=cover["merges"].get(row["name"], 0))
        row["wide_batch"] = wide_of(row["name"])
        if row["name"] == "knn":
            row["every_k"] = [fields(v) for rs in cover["timed"].values() for v in rs
                              if v["k"] <= 32]
    select = [fields(v) for rs in cover["timed"].values() for v in rs if v["k"] > 32]
    rows.append({"name": "knn_select", "route": "cuda",
                 "source": "cooper_mapper_torch/csrc/knn.cu",
                 "replaces": "cooper_mapper_tpu/ops/pallas/knn_stream.py:187",
                 "launches": cover["launches"]["knn_select"], **select[0],
                 "more_shapes": select[1:],
                 "coverage": dict(launches=cover["launches"]["knn_select"], merges=0),
                 "wide_batch": cover["wide"]["knn k=40"]})
    # the split k-NN's merge: launched once by each k-NN call that splits M
    merge_rows = [fields(v) for v in cover["merge_rows"]]
    rows.append({"name": "merge_first_k", "route": "cuda",
                 "source": "cooper_mapper_torch/csrc/split.cuh",
                 # no TPU counterpart: the merge of the split search of knn_stream.py:187
                 "replaces": "cooper_mapper_tpu/ops/pallas/knn_stream.py:187",
                 "launches": ss_launches["merges"]["knn"], **merge_rows[0],
                 "more_shapes": merge_rows[1:],
                 "coverage": dict(launches=cover["merges"]["knn"], merges=0)})
    pg_stat = lambda r: (f"{r['solver']} n={r['n']} {r['iters_per_s'][0]:.2f} / "
                         f"{r['iters_per_s'][1]:.2f} LM iterations/s, "
                         f"{min(r['ms']):.1f} ms per optimize")
    sm_scenes = "; ".join(f"eig {t:.0f}: degenerate {v['degenerate']}, signs {v['signs']}, "
                          f"|dx| direct {v['direct']:.3g} / card-signed {v['signed']:.3g}"
                          for t, v in sm_parity["scenes"].items())
    off_stat = lambda s, v: (f"{OFFLINE_SENSORS[s][1]} ms per sweep {min(v['ms']):.1f} / "
                             f"{float(np.median(v['ms'])):.1f}, drift {v['drift']:.4f} m "
                             f"(height {v['height']:+.4f}), organize_unordered "
                             f"{v['org_ms']:.1f} ms, peak {v['peak']:.1f} MiB, card vs "
                             f"CPU per solve {v['cpu']['local']:.3g}, free run "
                             f"{[round(x, 6) for x in v['cpu']['dx']]}, "
                             f"less_flat rings "
                             f"{ring_spans(v['feats']['less_flat'][2])}, map solves passing "
                             f"the gate {sum(ok for _, ok, _ in v['solves'])} of "
                             f"{len(v['solves'])}")
    log(f"[40] summary: build {build_s:.2f} s; odometry {sps_best:.1f} solves/s best "
        f"({sps_med:.1f} median) at B={BATCH}; scan-to-map {sm_best:.1f} solves/s best "
        f"({sm_med:.1f} median) at B={SM_BATCH}; single stream ms per sweep (best / median) "
        + "; ".join(f"{r} route odometry {v['stat']['odometry'][0]:.1f} / "
                    f"{v['stat']['odometry'][1]:.1f}, mapping {v['stat']['mapping'][0]:.1f} / "
                    f"{v['stat']['mapping'][1]:.1f}" for r, v in ss_stats.items())
        + f"; localization steady error {loc_steady:.4f} m (seed {loc_seed:.4f}); reduced "
        f"card vs CPU {reduced_dx:.3g}; pipeline (mapping, IMU) ms per sweep best / median "
        f"{min(pipe_run['ms']):.1f} / {float(np.median(pipe_run['ms'])):.1f}, final error "
        f"{pipe_run['gt_err']:.4f} m; localization pipeline steady {pipe_loc['steady']:.4f} m "
        f"(seed {pipe_loc['seed_err']:.4f}); local {local_run['gt_err']:.4f} m, ATE "
        f"{local_run['ate']:.4f}; Quick start ATE mapping {quick['ate']:.4f} / odometry "
        f"{quick['ate_odo']:.4f} m; reduced pipeline card vs CPU {reduced_pipe_dx}; pose graph "
        + "; ".join(pg_stat(pg_run[k]) for k in ("dense", "cg", "cg_big"))
        + f"; pose graph card vs CPU {pg_cpu_dx}; loop drive keyframe ATE graph "
        f"{gdrive['ate'][0]:.4f} / mapping {gdrive['ate'][1]:.4f} m at score_threshold "
        f"{LOOP_SCORE}, graph stage {gdrive['stage_ms']:.1f} ms per call, ms per sweep "
        f"{min(gdrive['ms']):.1f} / {float(np.median(gdrive['ms'])):.1f}; ICP card vs CPU "
        f"{icp_run['icp_dT']:.3g}; saved map localizes at {save_run['loc_err']:.4f} m; graph "
        f"pipeline card vs CPU {graph_dx:.3g}; parity: golden odometry trace |dx| split "
        f"{golden['split']:.3g} / fused {golden['fused']:.3g} (oracle {golden['oracle_s']:.2f} s), "
        f"odometry parity {parity_sps['parity'][0]:.1f} / {parity_sps['parity'][1]:.1f} solves/s "
        f"against native {parity_sps['native'][0]:.1f} / {parity_sps['native'][1]:.1f} at "
        f"B={BATCH}, parity drive final error {parity_drive['err']:.4f} m, scan-to-map parity "
        f"card vs CPU {sm_parity['dx']:.3g}, map scene {sm_scenes}; dewarp_passes=2 Quick start "
        f"ATE {passes2['ate']:.4f} / odometry {passes2['ate_odo']:.4f} m (1 pass "
        f"{quick['ate']:.4f} / {quick['ate_odo']:.4f}), reduced card vs CPU {passes2['dx']:.3g}; "
        f"extract_features_debug card vs CPU differing points {debug_differ}; corridor "
        f"(dynamic map) ATE {corridor['ate']:.4f} m, late success {corridor['late']:.3f}, "
        f"flushed {corridor['flushed']} / loaded {corridor['loaded']}, paging "
        f"{corridor['paging'][1]:.2f} ms per call steady, ms per sweep "
        f"{min(corridor['ms']):.1f} / {float(np.median(corridor['ms'])):.1f}, forward "
        f"{CORRIDOR_OUT} sweeps static vs dynamic {corridor['transparent_dx']:.3g} (ms per "
        f"sweep median {float(np.median(corridor['static_ms'])):.1f} / "
        f"{float(np.median(corridor['dynamic_ms'])):.1f}); converter {convert['n']} points, "
        f"surf {convert['n_surf']} / corner {convert['n_corner']}, {convert['cubes']} cubes, "
        f"dropped {convert['dropped']}, labels differing {convert['differ']}, k-NN "
        f"{convert['row']['ms']:.2f} ms, localization on it {convert['steady']:.4f} m steady "
        f"from the mapping poses, ATE {convert['ate']:.4f} m (phase 15: {pipe_loc['steady']:.4f} "
        f"steady); bag replay final error {bag['err']:.4f} m, "
        f"valid cells organize_unordered / binner {bag['cells']}; phases 30-33 "
        f"{corridor['seconds'] + convert['seconds'] + bag['seconds'] + traced['seconds']:.1f} s; "
        f"parallel: one rank (NCCL) sharded odometry {one['odometry']['sps']['sharded'][0]:.1f} "
        f"solves/s (unsharded {one['odometry']['sps']['unsharded'][0]:.1f}), scan-to-map "
        f"{one['scan_match'][0]:.1f}, LM dense / CG {one['lm_dense']['its'][0]:.2f} / "
        f"{one['lm_cg']['its'][0]:.2f} iterations/s, all bit-identical to the unsharded runs; "
        f"bucketed {bucketed['sps']['bucketed'][0]:.1f} solves/s against homogeneous "
        f"{bucketed['sps']['homogeneous'][0]:.1f} ({len(bucketed['plan'])} dispatches, max |dx| "
        f"{bucketed['dx']:.3g}); {PAR_RANKS} ranks ({two['backend']}): "
        + "; ".join(f"rank {r}: odometry |dx| {v['odometry_dx']:.3g}, LM dense / CG "
                    f"{v['lm_dense']['its'][0]:.2f} / {v['lm_cg']['its'][0]:.2f} iterations/s, "
                    f"pipeline max error {v['pipe_err']:.4g} m, stripe "
                    f"{v['stripe_bytes'] / 2**20:.1f} MiB, peak {v['peak_mib']:.1f} MiB"
                    for r, v in enumerate(two["ranks"]))
        + f"; phases 34-36 {one['seconds'] + bucketed['seconds'] + two['seconds']:.1f} s; "
        + "; ".join(off_stat(s, v) for s, v in offline.items())
        + f"; selftest {script_run['selftest']}; demos "
        + "; ".join(f"{k} {script_run[k]['shown']}" for k in
                    ("demo_mapping", "demo_localization", "demo_graph_slam", "demo_wander"))
        + f"; phases 37-39 {scripts_s:.1f} s with the CPU runs' wait (phase 41 inside it, "
        f"not counted); coverage: the k-NN "
        f"bit for bit at every k of {COVER_KS[0]}..{COVER_KS[-1]} listed, every search kernel "
        f"at B={WIDE_B}, batch_odometry_solve at B={WIDE_B} {cover['odo']['sps']:.1f} solves/s "
        f"(rows 0..{BATCH - 1} |dx| {cover['odo']['dx']:.3g}), scan-to-map knn=8 card vs CPU "
        f"{cover['sm_dx']:.3g}, classify labels differing {cover['labels']}, phase 41 "
        f"{cover['seconds']:.1f} s; on {name} ({smi})")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
