#!/usr/bin/env python3
"""Drive tpu_pt_torch's main path once on one CUDA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
``python3 chip_smoke.py --profile`` instead profiles one frame of
bench.py's frame (unfused, fused_nee and regen), of the sphere box
(unfused and fused), of the big-mesh frame through each pair of clustered
kernels (interleaved with the lean one) and of each Whitted main-path run
(device busy and idle share, time by kernel) and prints no result line.
It runs in three parts: ``--profile pt`` (the bench frame, the sphere
box), ``--profile whitted`` (the Whitted runs) and ``--profile big`` (the
big-mesh frames, over 1,200 s); ``--profile rest`` is the first two, and
``--profile`` alone runs all three, one after the other.
It needs one CUDA device, ``nvcc`` (the kernels are built from
``tpu_pt_torch/csrc/`` on first use) and nothing of JAX. Phases, one line
each; any failure raises and exits non-zero before the last line:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: compile and load the CUDA kernels (one nvcc per source, in
   parallel);
3. assets: write the 100k-triangle big mesh (``tools/make_assets.py
   --big``) under build/assets and load it onto the card;
4. kernels: each kernel against its plain PyTorch version on the same
   rays on the card (camera rays plus rays leaving the surfaces they hit,
   and shadow rays from those points to the light), with times of both:
   the dense kernels at 262,144 rays; the clustered kernels on the big
   mesh at the big path's width of 32,768 rays with every eighth lane
   parked as the wavefront parks them, bitwise, timed there and at
   262,144 rays; then bitwise on the exact inputs of one K6 and one K8
   call recorded from a bench_big frame;
5. goldens: the five path-trace golden modes (tools/make_goldens.py:
   128^2, 32 spp, one frame) rendered through the kernels, RMSE < 0.01
   against tests/goldens/;
6. main path: the reference app's launch (512^2, 128 spp, depth 4, IS+NEE,
   mixed Cornell box, 2 progressive frames), bench.py's canonical frame
   (1024^2, 16 spp, depth 8, IS+NEE, frame 0 warm-up, frames 1-4 timed),
   a sphere-box frame (2,264 triangles: K3 and K2; frame 0 warm-up,
   frame 1 timed), and
   tools/bench_big.py's big-mesh frame (512^2, 4 spp, depth 8, IS+NEE,
   frame 0 warm-up, frames 1-2 timed: the clustered kernels), each with
   the kernel launch counters zeroed before and read after;
7. cross-check: a 32^2 x 2 spp, depth-4 big-mesh frame rendered on the
   CPU (plain versions) and on the card (kernels) agrees within
   tests/test_torch_render.py's bound.

The glTF / Whitted pipeline and the instanced kernels K9 / K10:

8. Whitted goldens: whitted-pbr and whitted-alpha-shadow at
   tools/make_goldens.py's configurations through the kernels, RMSE <
   0.01;
9. Whitted main path: tools/bench_whitted.py's frame (512^2, 8 spp,
   depth 8, pixelq; frame 0 warm-up, frames 1-3 timed) on the 1,001-
   instance forest (auto must keep the instances: K9/K10), on pbr_big.glb
   (100,354 triangles flattened: K6) and on foliage kept instanced
   (2 spp), counters zeroed before each run and read after (K10 once per
   instanced shadow call); each run's warm-up frame records one call of
   every kernel it launches on each table;
10. instanced kernels: K9 and K10 bitwise against their plain versions
   on the forest at the frame's 16,384-lane width with every eighth lane
   parked (timed there and at 262,144 rays), K10 also on shadow rays from
   above the forest's edge, blocked only in part, on foliage's opaque
   subset and on tables of one and two instances, and both on the
   mirrored / non-uniformly scaled fixture of tests/test_instanced.py
   built by the port; then every call recorded in 9 (the forest's K9 /
   K10, pbr_big's K6 / K8, foliage's K9 on both of its tables and its
   K10 on the opaque subset), bitwise;
11. Whitted cross-checks: the forest at 64^2 x 2 spp instanced against
   flattened (492,002 triangles through K6/K8), within
   tests/test_torch_instanced.py's bound; a small instanced glTF at 32^2
   on the CPU (plain versions) against the card.

The fused closest-hit + NEE kernels K4 / K5 (``RenderConfig.fused_nee``)
and the entry points around the path tracer:

12. fused kernels: K4's dense body on the mixed box (432 rows, 24-row
   occluder subset)
   and K5 on the sphere box (2,280 rows) at 262,144 rays, light samples
   from the counter RNG, one lane in eight parked, bitwise against their
   plain versions (t, row, K5's normal and material; the occlusion flag
   on hit lanes); the direct-lighting goldens under ``fused_nee``;
13. fused main path: bench.py's frame under ``fused_nee`` (K4's walk once
   per round, K1 and K2 never) and the sphere-box frame (K5 once per round),
   each against its unfused twin of phase 6, and bench.py's frame on the
   ``regen`` scheduler against ``pixelq``; then the K4 / K5 calls
   recorded from the two fused warm-up frames, bitwise;
14. entry points: ``python -m tpu_pt_torch.cli render`` on the mixed box
   (two frames with --checkpoint, then --resume for two more, bitwise
   equal to four straight frames), a glTF render through the Whitted
   route with --validate, ``python -m tpu_pt_torch.bench`` on a short
   BENCH_* setting, and ``debug.trace_pixel`` under ``fused_nee``, whose
   per-bounce contributions sum to that pixel in a 1-spp frame.

The rest of the clustered kernels (K6f: the full carry; K7 lean and full
and K8b: a group of lanes a ray tests every box and sweeps each one its
ray pierces) and the rest of the geometry (LBVH, scene-JSON and
glTF-extras primitives and curves):

15. kernels (in phase 4): K6f, K7 lean, K7 full and K8b on the big mesh at
   32,768 rays with every eighth lane parked, bitwise against their plain
   versions (u and v included) and against K6 / K8 on the same rays, timed
   there and at 262,144 rays; K7 lean and full and K8b at every width they
   are built for, each bitwise against K6 / K6f / K8, and the widths the
   package picks; K7 on the big mesh cut into clusters of 256 rows against
   its plain versions;
16. big-mesh variants: tools/bench_big.py's frame three more times, under
   ``TPT_LEAN_BIG=0`` (K6f + K8, K6 never), ``TPT_INKB=1`` (K7 lean + K8b,
   K6 and K8 never) and both (K7 full + K8b), each accumulator equal to
   the lean frame's bit for bit; pbr_big.glb's Whitted frame under
   ``TPT_LEAN_UV=0`` (K6f with u, v) against the lean one within
   tests/test_torch_whitted.py's bound; one call of each new wrapper
   recorded from a warm-up frame, bitwise;
17. huge mesh: ``tools/make_assets.py --huge`` (1,001,124 triangles) under
   build/assets, loaded (seconds spent writing, parsing, ordering, building
   the LBVH and packing), K7 lean timed at 32,768 rays, bench_big's frame
   through K6 + K8 and through K7 + K8b: NOT_DONE == 0, finite, the two
   accumulators equal;
18. LBVH: the big mesh's primary rays (64^2) through ``bvh`` against
   ``dense`` (hit / miss and ids agree on >= 0.999 of them: the walk tests
   Moller-Trumbore, the kernels the plane + edge form, and they may
   disagree on an edge), a 64^2 x 2 spp frame through each within
   tests/test_torch_render.py's bound, and the time of one closest call
   at 32,768 rays;
19. goldens (in phases 5 and 8): primitives.png and curves.png (scene
   JSON, path tracer) and whitted-prims-curves.png (pbr_prims.gltf).

The first three scheduler families of pallas_ablations.py (K11 rotated,
K12 streamed, K13 cluster-binned: ``tpu_pt_torch/intersect/ablations.py``):

20. kernels (in phase 4): ``closest_rotated``, ``closest_streamed``,
   ``occluded_streamed``, ``closest_cbin`` and ``occluded_cbin`` on the big
   mesh at 32,768 rays with every eighth lane parked, bitwise against
   their plain versions and (through their whole paths) against K6 / K8,
   also at 1,000 and 77 rays; K12 with the guard on and off (each side at
   its own tile and at every width it is built for; the closest side at
   262,144 rays against its plain version and K6 too), K13 under six cap
   settings (``CBIN_GROUP`` 1 and 8, starved caps, ``TPT_CBIN_LVL=1`` /
   ``2``, ``TPT_CBIN_EXACT=0``), K11 under an unknown, the oracle and a
   cycled wrong prediction, at every width it is built for (against its
   plain version per prediction and K6; at 262,144 rays against K6); the
   list build on the card (``stream_lists``)
   bitwise against its plain version ``stream_candidates`` (cand, keys,
   cnt, far) at the any-hit's, the closest side's and K15's tiles, at
   32,768 parked rays, 262,144, 1,000 and 77, on every box tied ten ways
   and with boxes entered beyond T_FAR; K13's schedule on the card
   (``cbin_schedule``) against its plain version ``_cbin_schedule``
   (``jtab``, ``incomplete``, the meta bitwise, each cluster's run the
   same set of groups) under every cap setting, and its folded kernels
   against the reference's reduces over ``cbin_pairs``' per-pair results
   on every lane that is not incomplete; the kernels and their schedule
   builds (``stream_lists``, ``cbin_schedule``) timed apart;
21. big-mesh variants (in phase 16): the frame under ``TPT_SEED=1``,
   ``TPT_STREAM=1`` and ``TPT_CBIN=1``, accumulators bitwise equal to the
   lean frame's, the selected wrappers launched once per round (K13's
   frame also K12 and K8, its completion passes), the replaced ones
   never, the list build once per list a round (LIST_BUILDS), K13's
   schedule twice a round (CBIN_SCHEDULES); the lean
   frame again under ``TPT_PRED=0``, bitwise equal; one call of each
   wrapper recorded from a warm-up frame (of the list build, one at each
   tile), bitwise; the default frames (phase 6) launch none of K8b, K12's
   any-hit and the list build;
22. incoherent rays: ``tools/bench_incoherent_torch.py``'s 262,144 random
   rays on the big mesh through every scheduler (K6, K7, K11, K12, K13,
   K14, K15 serial and bundled; K8, K8b, K12, K13, K14, K15 both), all
   results equal, device times in interleaved pairs against K6 / K8; the
   list build bitwise against ``stream_candidates`` on those rays at
   each of its three tiles.

The rest of pallas_ablations.py (K14 pair-binned, K15 8-lane groups:
``tpu_pt_torch/csrc/ablations_binned.cu``) and the bf16 probe K16:

23. kernels (in phase 4): ``closest_binned`` / ``occluded_binned`` (k = 12)
   and ``closest_grp`` / ``occluded_grp`` (serial and bundled) on the big
   mesh at 32,768 rays with every eighth lane parked, bitwise against
   their plain versions (K15 at every width, serial and bundled, against
   its plain version and K6 / K8 there and at 262,144 rays), timed apart
   from their schedule builds
   (``pair_schedule``, the group lists) and at 262,144 rays; their whole
   paths bitwise against K6 / K8 there and at 1,000 and 77 rays, K14 also
   at k = 2, where the completion pass carries real lanes; K14's pair
   schedule built on the card (``pair_schedule``) against its plain
   version ``_pair_schedule`` (``tile_sid``, ``next_tn``, ``overflow``
   bitwise, each cluster's run the same set of rays), timed, at every tile
   width of ``BINNED_TILES`` and k = 12 and 2; K14's kernels at every
   width bitwise equal to the chosen one's;
24. big-mesh variants (in phase 16): the frame under ``TPT_BINNED=1``
   (K14 and its completion passes K6 and K8 once per round, its pair
   schedule twice), ``TPT_GRP=1``
   and ``TPT_GRP=2`` (K15 once per round, K6 / K8 never), accumulators
   bitwise equal to the lean frame's, one call of each wrapper recorded
   from a warm-up frame and held bitwise;
25. incoherent rays (in phase 22): K14 and K15 among the paths, K11 and
   K15 at every width (``_incoherent_widths``: against K6 / K8, K15 also
   against its plain version, K11 at its shipped width); then the
   list build past its caps (``ablations.list_route``): bitwise against
   ``stream_candidates`` at tiles of 512 rays (past LIST_MAX_TILE) on the
   big mesh's 784 boxes, and on a table of more than 8,192 clusters (the
   big mesh 11 times over, built on the card: 8,624 clusters, 1.1M rows)
   at every tile (K15's tiles of 8, the small-tile route, on
   SMALL_CAP_RAYS of its rays), and at 8,192 and 8,193 of its boxes; the
   ``TPT_STREAM=1`` closest and any-hit paths on that table bitwise equal
   to K6 / K8, and K12's closest kernel there at tiles of 512, guard on
   and off, bitwise equal to its plain version and K6, with the phase's
   seconds;
26. bf16 probe: ``tools/microbench_bf16_torch.py``'s f32 chain bitwise
   against its plain PyTorch chain on the card, the bf16 chain within one
   bf16 ulp (the count of differing elements printed), then 200 chained
   calls of each, timed: ms per call, Tops/s, the bound and the ratio.

The tree walks (``csrc/walk.cuh``: one ray to a group of G lanes walks a
box tree near first): K6, K6f and K8 over the kd tree of the clusters
(``clustered.walk_group``), K5, K3, K2, K1 and K4 over kd copies of the
dense tables (``dense.kd_tables``), K9 and K10 over the tree of the
instances (``instanced.instance_tree``). Every kernel of a default path
walks; the dense bodies of K1-K4 stay on the path of the tables without
a kd copy (``cornell_box.obj``):

27. kernels (in phase 4): the walk's K6, K6f and K8, each bitwise
   against its plain version at 32,768 rays with every eighth lane parked
   and timed there and at 262,144 rays; node tests and clusters swept per
   live ray of a walk at the final bound (``_tree_leaves_plain``), which
   sets the walk's bound; the time of ``cluster_tree``;
28. huge mesh (in phase 17): one K6 and one K8 call at 32,768 rays (one
   lane in eight parked) bitwise against K7 / K8b on the same rays, the
   walks timed, with their node tests;
29. fused kernels (in phase 12): K5's walk bitwise against the dense
   plain version at 262,144 rays with one lane in eight parked; its bound
   from its own node tests and reached clusters (``_fused_walk_work``)
   beside the dense count; 65,536 rays aimed at shared edges (rows tie
   on t, the lowest dense row wins) against the plain version;
30. instanced kernels (in phase 10): K9's and K10's walks bitwise against
   their plain versions on the forest at 16,384 parked rays and at
   262,144, K10 also on the shadow rays from above the forest's edge, on
   foliage's opaque subset (301 real instances) at 16,384 parked rays, on
   the fixture and on tables of one and two of its instances; each
   walk's bound from its own instance-node tests (``_inst_work``; an
   occluded shadow ray needs one path), the node tests of a
   blocked and of an open shadow ray apart; in phase 9 the forest and
   foliage frames launch K10 once per instanced shadow call;
31. kernels (in phase 4): K3's and K2's walks on the sphere box at the
   frame's 65,536 lanes with one in eight parked and at 262,144 rays,
   each bitwise against its plain version and against its dense body,
   the two timed in interleaved pairs; each walk's bound from its own
   node tests and reached clusters beside the dense count; K3 also on
   65,536 rays aimed at shared edges;
32. main path (in phase 6): the sphere-box frame launches K3's and K2's
   walks once per round each and their dense bodies never; no other run
   launches a walk of K2 or K3; the two calls recorded from its warm-up
   frame, bitwise against their plain versions and their dense bodies,
   timed in pairs;
33. fused kernels (in phase 12): K1's and K4's walks on the mixed and
   monkey boxes at 262,144 rays with one in eight parked, each bitwise
   against its plain version and against its dense body, the two timed in
   interleaved pairs; each walk's bound from its own node tests and
   reached clusters beside the dense count; both on 65,536 rays aimed at
   shared edges; K2's walk on the monkey box's subset against its dense
   body; the host time of ``dense.prepare`` and of its kd copy;
34. main path (in phases 5, 6 and 13): the path-trace goldens, the
   reference launch, the bench frame and its ``regen`` run launch K1's
   walk (the reference launch and the bench frame once per round), the
   ``fused_nee`` goldens and bench frame K4's walk (once per round), and
   never K1's or K4's dense body; one call of each walk recorded from the
   warm-up frames (reference launch, bench frame, fused bench frame),
   bitwise against its plain version and its dense body, timed in pairs;
35. multi-GPU: a one-rank NCCL world (``tpu_pt_torch.dist``) and its
   (1, 1) mesh; bench.py's frame (two frames) through the sharded step,
   its accumulators bitwise equal to two ``render_frame`` runs' (within
   tests/test_dist.py's 1e-5 when those two differ from each other, with
   the count of differing pixels printed), K1's walk and K2 once per
   round; the forest at 256^2 x 2 spp through the sharded step against
   ``render_whitted_frame`` (K9 and K10 launched); the 4K frame of
   tools/bench_dist_torch.py in the same world; the NCCL ``all_reduce``
   of the 4K radiance, timed with CUDA events.

The last modules: the native host library, the viewer and the
convergence report (``phase_build`` raises when the native library does
not build: the run never falls back to the Python paths):

36. native: its OBJ parse against the Python one on the three Cornell
   boxes, the big and the huge mesh (both times); ``load_scene`` of the
   huge mesh with it and under ``TPU_PT_NO_NATIVE=1``; the host LBVH of
   the big and the huge mesh (leaves cover every triangle once, the skip
   walk visits every node; its host time beside the device build's), the
   big mesh's primary rays through it against the device-built tree
   (ROW_AGREE); the PNG goldens through its unfilter against numpy's;
37. viewer: ``cli view`` headless in this process on the reference
   launch (mixed box, 512^2 x 128 spp, depth 4, IS + NEE, 3 frames: K1's
   walk + K2) and on the forest (512^2 x 8 spp, depth 8, 2 frames: K9 +
   K10), each PNG bitwise against the same frames of ``render_frame`` /
   ``render_whitted_frame``; the draw times of a 512^2 frame;
   ``HttpDisplay`` on a free port, /frame.png and /status fetched over
   loopback equal to what was drawn;
38. convergence: tools/convergence_torch.py's curves at 256^2 x 16 spp,
   8 reference and 4 test frames (cut from 64 + 16 to fit this run),
   NEE's speed-up holding.

The round's counter RNG (``csrc/rng.cu``):

39. rng (after phase 2): ``tpt_bounce_uniforms`` and ``tpt_uniform``
   (k = 2 and 4) at 8,388,608 lanes, the flagship box's wavefront, with
   counters past 2^32 and negative, bitwise against the plain int64
   version run on the card, each timed back to back beside its bytes
   bound and the plain version's time; in phase 6 every main-path run
   launches one bounce draw a round and one jitter draw a round plus
   each frame's first fill, so no draw of those frames took the plain
   version.

Every kernel's record carries its bound: the larger of the operations
these inputs need over the card's f32 rate and the bytes over its memory
rate (K16: its operations over the instruction rate of its type, from the
card's SM count and maximum SM clock).

The last three lines are the kernels' JSON record (the RNG's two entry
points last), the nvidia-smi line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import subprocess
import sys
import time

# The port must run without JAX: make any import of it fail loudly.
for _name in ("jax", "jaxlib", "flax", "tpu_pt"):
    sys.modules[_name] = None

REPO = pathlib.Path(__file__).resolve().parent
ASSETS = REPO / "assets"
BUILD_ASSETS = REPO / "build" / "assets"    # generated (gitignored)
GOLDENS = REPO / "tests" / "goldens"

N_RAYS = 262144          # the pixelq wavefront width on the main path
N_PLAIN_BIG = 32768      # the big path's width (262,144 items // 8 lanes)
PARK_EVERY = 8           # every eighth big-mesh lane parked
TOL_T = 1e-4             # |t_kernel - t_plain| bound (pallas_bf.py:28-34)
ROW_AGREE = 0.999        # rows may differ only on shared-edge ties
GOLDEN_RMSE = 0.01       # tests/test_goldens.py bound
GOLDEN_MODES = [         # tools/make_goldens.py MODES
    ("no-importance-no-direct", dict(use_importance_sampling=False,
                                     use_direct_lighting=False)),
    ("importance-no-direct", dict(use_importance_sampling=True,
                                  use_direct_lighting=False)),
    ("importance-with-direct", dict(use_importance_sampling=True,
                                    use_direct_lighting=True)),
    ("3-bounce", dict(use_importance_sampling=True,
                      use_direct_lighting=True, max_depth=3)),
    ("16-bounce", dict(use_importance_sampling=True,
                       use_direct_lighting=True, max_depth=16)),
]
# Scene-JSON goldens (analytic primitives; swept-sphere curves), at the
# path-trace goldens' configuration with IS + NEE.
JSON_GOLDENS = [("primitives", "cornell_prims.json"),
                ("curves", "cornell_curves.json")]
_DENSE = "tpu_pt_torch/csrc/dense_intersect.cu"
_CLUSTERED = "tpu_pt_torch/csrc/clustered_intersect.cu"
_INSTANCED = "tpu_pt_torch/csrc/instanced_intersect.cu"
_BUILD = "tpu_pt_torch/csrc/clustered_build.cu"
_ABLATIONS = "tpu_pt_torch/csrc/ablations_intersect.cu"
_BINNED = "tpu_pt_torch/csrc/ablations_binned.cu"
_BF16 = "tpu_pt_torch/csrc/microbench_bf16.cu"
KERNELS = {   # wrapper name -> (source, TPU kernel it replaces)
    "closest_lean": (_DENSE, "tpu_pt/intersect/pallas_bf.py:976"),
    "occluded": (_DENSE, "tpu_pt/intersect/pallas_bf.py:1299"),
    "closest_full": (_DENSE, "tpu_pt/intersect/pallas_bf.py:938"),
    "closest_clustered": (_CLUSTERED, "tpu_pt/intersect/pallas_bf.py:1042"),
    "occluded_clustered": (_CLUSTERED, "tpu_pt/intersect/pallas_bf.py:1204"),
    "closest_inst": (_INSTANCED, "tpu_pt/intersect/pallas_inst.py:236"),
    "occluded_inst": (_INSTANCED, "tpu_pt/intersect/pallas_inst.py:292"),
    "closest_nee_lean": (_DENSE, "tpu_pt/intersect/pallas_bf.py:1263"),
    "closest_nee_full": (_DENSE, "tpu_pt/intersect/pallas_bf.py:1222"),
    "closest_clustered_full": (_CLUSTERED,
                               "tpu_pt/intersect/pallas_bf.py:993"),
    "closest_clustered_b": (_BUILD, "tpu_pt/intersect/pallas_bf.py:1137"),
    "closest_clustered_full_b": (_BUILD,
                                 "tpu_pt/intersect/pallas_bf.py:1088"),
    "occluded_clustered_b": (_BUILD, "tpu_pt/intersect/pallas_bf.py:1182"),
    "closest_rotated": (_ABLATIONS,
                        "tpu_pt/intersect/pallas_ablations.py:84"),
    "closest_streamed": (_ABLATIONS,
                         "tpu_pt/intersect/pallas_ablations.py:210"),
    "occluded_streamed": (_ABLATIONS,
                          "tpu_pt/intersect/pallas_ablations.py:275"),
    "closest_cbin": (_ABLATIONS, "tpu_pt/intersect/pallas_ablations.py:905"),
    "occluded_cbin": (_ABLATIONS,
                      "tpu_pt/intersect/pallas_ablations.py:1014"),
    "closest_binned": (_BINNED, "tpu_pt/intersect/pallas_ablations.py:1272"),
    "occluded_binned": (_BINNED,
                        "tpu_pt/intersect/pallas_ablations.py:1365"),
    "closest_grp": (_BINNED, "tpu_pt/intersect/pallas_ablations.py:1760"),
    "occluded_grp": (_BINNED, "tpu_pt/intersect/pallas_ablations.py:1791"),
    # K12's lists (and K15's), which the JAX package builds in XLA outside
    # its kernels: part of K12's path, built on the card.
    "stream_lists": (_ABLATIONS, "tpu_pt/intersect/pallas_ablations.py:408"),
    # K14's pair schedule, which the JAX package builds in XLA outside its
    # kernels: part of K14's path, built on the card.
    "pair_schedule": (_BINNED, "tpu_pt/intersect/pallas_ablations.py:1156"),
    # K13's schedule (cbin_pairs), which the JAX package builds in XLA
    # outside its kernels: part of K13's path, built on the card.
    "cbin_schedule": (_ABLATIONS, "tpu_pt/intersect/pallas_ablations.py:814"),
    "chain_f32": (_BF16, "tools/microbench_bf16.py:37"),
    "chain_bf16": (_BF16, "tools/microbench_bf16.py:37"),
    # K3 and K2 as walks of kd copies (the sphere box's table and occluder
    # subset); their dense bodies above stay on the path for the tables
    # without a copy.
    "closest_full_tree": (_DENSE, "tpu_pt/intersect/pallas_bf.py:938"),
    "occluded_tree": (_DENSE, "tpu_pt/intersect/pallas_bf.py:1299"),
    # K1 and K4 as walks of kd copies (the mixed and monkey boxes' tables;
    # K4's shadow ray over the subset's copy, or its rows when it has
    # none); their dense bodies above stay on the path for the tables
    # without a copy.
    "closest_lean_tree": (_DENSE, "tpu_pt/intersect/pallas_bf.py:976"),
    "closest_nee_lean_tree": (_DENSE, "tpu_pt/intersect/pallas_bf.py:1263"),
}
# The dense body of each walk of K1-K4: on the path for the tables without
# a kd copy, and held against the walk where there is one.
DENSE_BODY = {"closest_full_tree": "closest_full", "occluded_tree": "occluded",
              "closest_lean_tree": "closest_lean",
              "closest_nee_lean_tree": "closest_nee_lean"}
SPHERE_TAG = "sphere box 512^2 x 16 spp, depth 4"
REFERENCE_TAG = "reference launch 512^2 x 128 spp, depth 4, mixed"
BENCH_TAG = "bench.py 1024^2 x 16 spp, depth 8, mixed"
# The mixed box (K1's and K4's walks: 262,144 rays with one lane in
# PARK_EVERY parked, as the kernels phase times K4) and the monkey box
# (1,320 rows, 1,232 occluders: both copies), for the lean walks' checks.
LEAN_BOXES = (("mixed", "cornell_box_mixed.obj", "wide"),
              ("monkey", "cornell_box_monkey.obj", "monkey"))
N_SPHERE_RAYS = 65536    # the sphere-box frame's pixelq width
DENSE_SUBSET_ROWS = 2048  # the largest occluder subset with no kd copy
CLOSEST_K6 = ("closest_clustered", "closest_clustered_b")
CLOSEST_K6F = ("closest_clustered_full", "closest_clustered_full_b")
OCCLUDED_K8 = ("occluded_clustered", "occluded_clustered_b")
# The wrappers of tpu_pt_torch.intersect (K16's live in its tool).
INTERSECT_WRAPPERS = tuple(k for k, (src, _) in KERNELS.items()
                           if src != _BF16)
# The bound: the larger of the operations over the card's f32 rate
# without tensor cores and the bytes over its memory rate (H100 SXM data
# sheet). Operations per ray-row pair (the plane + edge test, as counted
# since the first kernels), per slab test of a box and per ray transform
# into an instance's mesh space.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PAIR_FLOPS = 28
BOX_FLOPS = 24
XFORM_FLOPS = 33
# The Whitted pipeline: tools/bench_whitted.py's view and frame (512^2,
# 8 spp, depth 8, pixelq), and tools/make_goldens.py's two Whitted goldens.
WHITTED_VIEW = dict(eye=(6.0, 4.5, 7.0), lookat=(0.0, 0.8, 0.0), fov_y=40.0)
WHITTED_BENCH = dict(width=512, height=512, spp=8, max_depth=8,
                     background=(0.1, 0.15, 0.25))
WHITTED_GOLDENS = [
    ("whitted-pbr", "pbr_test.gltf", WHITTED_VIEW,
     dict(width=128, height=128, spp=8, max_depth=8,
          background=(0.1, 0.15, 0.25))),
    ("whitted-prims-curves", "pbr_prims.gltf", WHITTED_VIEW,
     dict(width=128, height=128, spp=8, max_depth=8,
          background=(0.1, 0.15, 0.25))),
    ("whitted-alpha-shadow", "alpha_shadow.gltf",
     dict(eye=(2.0, 6.0, 13.0), lookat=(0.0, 0.5, 0.0), fov_y=45.0),
     dict(width=160, height=120, spp=8, max_depth=6,
          background=(0.05, 0.07, 0.12))),
]
FOREST = "forest.gltf"
# Whitted main-path runs: (tag, scene, instancing, frames rendered, last
# frames timed, config, kernels the run must launch). The forest (1,001
# instances; "auto" must keep them) takes K9/K10; pbr_big.glb (100,354
# triangles, flattened) takes K6, its shadow rays K2 or K8 by the size of
# its occluder subset; foliage keeps its 601 instances only when asked
# ("auto" flattens its 9,602 triangles, as the JAX loader does), and its
# alpha-masked leaves march through K9 over their subset table.
WHITTED_RUNS = [
    ("forest 512^2 x 8 spp, depth 8 (auto: instanced)", FOREST, "auto",
     [0, 1, 2, 3], 3, WHITTED_BENCH, ("closest_inst", "occluded_inst")),
    ("pbr_big 512^2 x 8 spp, depth 8 (flattened)", "pbr_big.glb", "auto",
     [0, 1, 2, 3], 3, WHITTED_BENCH, ("closest_clustered",)),
    ("foliage 512^2 x 2 spp, depth 8 (instanced)", "foliage.gltf",
     "instanced", [0, 1, 2, 3], 3, {**WHITTED_BENCH, "spp": 2},
     ("closest_inst", "occluded_inst")),
]
# The forest instanced against flattened (492,002 triangles through
# K6/K8), seen from above its edge (tests/test_gltf_whitted.py's forest
# view: the bench view inside the forest sees only shaded ground), and a
# small instanced scene on the CPU against the card.
FOREST_VIEW = dict(eye=(0.0, 35.0, 150.0), lookat=(0.0, 0.0, 0.0),
                   fov_y=50.0)
FOREST_CROSS = dict(width=64, height=64, spp=2, max_depth=8,
                    background=(0.5, 0.7, 0.9))
CITY_CROSS = dict(width=32, height=32, spp=2, max_depth=4,
                  background=(0.2, 0.3, 0.5))
INST_FLAT_RMSE = 2e-3    # tests/test_torch_instanced.py's bound
N_INST_RAYS = 16384      # the forest frame's pixelq width (262,144 / 16)
BIG_MESH = "big_mesh.obj"
BIG_TAG = "bench_big 512^2 x 4 spp, depth 8, big mesh"
BENCH_BIG = dict(width=512, height=512, spp=4, max_depth=8)
# Main-path workloads: (tag, scene, frames rendered, last frames timed,
# config, kernels the run must launch). The reference app's per-launch
# workload (PathTracerMain.cpp:42-59) and bench.py's canonical frame
# (bench.py:49-57) on the mixed box, whose closest hits take K1's walk
# and whose shadow rays take K2's dense body (24 occluders, no copy), the
# sphere box, whose 2,264 triangles take the walks of K3 and K2 (frame 0
# warms up and records their calls, frame 1 is timed), and
# tools/bench_big.py's frame (bench_big.py:38-41) on the 99,968-row big
# mesh, which takes the clustered kernels (its NEE occluder subset keeps
# 99,908 rows, so shadow rays take K8). All with IS + NEE. The walks
# launch once per round in the runs of WALK_RUNS and never elsewhere.
MAIN_RUNS = [
    (REFERENCE_TAG, "cornell_box_mixed.obj", [0, 1], 2,
     dict(width=512, height=512, spp=128, max_depth=4),
     ("closest_lean_tree", "occluded")),
    (BENCH_TAG, "cornell_box_mixed.obj", [0, 1, 2, 3, 4], 4,
     dict(width=1024, height=1024, spp=16, max_depth=8),
     ("closest_lean_tree", "occluded")),
    (SPHERE_TAG, "cornell_box_sphere.obj", [0, 1], 1,
     dict(width=512, height=512, spp=16, max_depth=4),
     ("closest_full_tree", "occluded_tree")),
    (BIG_TAG, BIG_MESH, [0, 1, 2], 2, BENCH_BIG,
     ("closest_clustered", "occluded_clustered")),
]
# The big-mesh frame through the other clustered kernels: (what, the JAX
# package's variables that select them, kernels the run must launch,
# kernels it must not).
BIG_VARIANTS = [
    ("full carry", dict(TPT_LEAN_BIG="0"),
     ("closest_clustered_full", "occluded_clustered"),
     ("closest_clustered", "closest_clustered_b", "closest_clustered_full_b",
      "occluded_clustered_b")),
    ("in-kernel list", dict(TPT_INKB="1"),
     ("closest_clustered_b", "occluded_clustered_b"),
     ("closest_clustered", "occluded_clustered", "closest_clustered_full",
      "closest_clustered_full_b")),
    ("full carry, in-kernel list", dict(TPT_LEAN_BIG="0", TPT_INKB="1"),
     ("closest_clustered_full_b", "occluded_clustered_b"),
     ("closest_clustered", "occluded_clustered", "closest_clustered_full",
      "closest_clustered_b")),
    ("rotated chain", dict(TPT_SEED="1"),
     ("closest_rotated", "occluded_clustered"),
     ("closest_clustered", "closest_streamed", "closest_cbin")),
    ("streamed", dict(TPT_STREAM="1"),
     ("closest_streamed", "occluded_streamed"),
     ("closest_clustered", "occluded_clustered", "closest_rotated",
      "closest_cbin", "occluded_cbin")),
    # K13 finishes its overflow through K12 (closest) and K8 (any-hit),
    # every round.
    ("cluster-binned", dict(TPT_CBIN="1"),
     ("closest_cbin", "occluded_cbin", "closest_streamed",
      "occluded_clustered"),
     ("closest_clustered", "closest_rotated", "occluded_streamed")),
    # Without the landing-slab prediction: the same kernels, the same frame.
    ("no prediction", dict(TPT_PRED="0"),
     ("closest_clustered", "occluded_clustered"),
     ("closest_rotated", "closest_streamed", "closest_cbin")),
    # K14 finishes its overflow through K6 and K8, every round.
    ("pair-binned", dict(TPT_BINNED="1"),
     ("closest_binned", "occluded_binned", "closest_clustered",
      "occluded_clustered"),
     ("closest_rotated", "closest_streamed", "closest_cbin", "closest_grp",
      "occluded_grp")),
    ("8-lane groups, serial", dict(TPT_GRP="1"),
     ("closest_grp", "occluded_grp"),
     ("closest_clustered", "occluded_clustered", "closest_binned",
      "occluded_binned", "closest_streamed")),
    ("8-lane groups, bundled", dict(TPT_GRP="2"),
     ("closest_grp", "occluded_grp"),
     ("closest_clustered", "occluded_clustered", "closest_binned",
      "occluded_binned", "closest_streamed")),
]
NEW_WRAPPERS = ("closest_clustered_full", "closest_clustered_b",
                "closest_clustered_full_b", "occluded_clustered_b",
                "closest_rotated", "closest_streamed", "occluded_streamed",
                "closest_cbin", "occluded_cbin", "closest_binned",
                "occluded_binned", "closest_grp", "occluded_grp",
                "stream_lists", "pair_schedule", "cbin_schedule")
# List builds per round of the big-mesh variants (the closest and the
# any-hit call each build one under TPT_STREAM and TPT_GRP; K13's closest
# completion pass one); every other variant and every default frame none.
LIST_BUILDS = {"streamed": 2, "cluster-binned": 1,
               "8-lane groups, serial": 2, "8-lane groups, bundled": 2}
# Pair schedules per round (K14's closest and any-hit call each build one);
# every other variant and every default frame none. The same for K13's
# schedule.
PAIR_SCHEDULES = {"pair-binned": 2}
CBIN_SCHEDULES = {"cluster-binned": 2}
# The any-hit kernels that go down a list (K8b, K12) and the list build:
# no default frame launches them.
SHADOW_LIST_KERNELS = ("occluded_clustered_b", "occluded_streamed",
                       "stream_lists")
# The wrappers the incoherent phase must launch (its lean closest path
# takes no full carry).
INCOHERENT_WRAPPERS = NEW_WRAPPERS[4:]
N_RAGGED = (1000, 77)    # ray counts that leave a ragged last block
SMALL_CAP_RAYS = 4096    # rays of the small-tile lists past the box cap
# The list build past its caps (phase_list_caps): the big mesh this many
# times over (8,624 clusters: past LIST_MAX_BOXES), and a tile past
# LIST_MAX_TILE.
LIST_CAP_COPIES = 11
LIST_CAP_TILE = 512
INCOHERENT = dict(n=262144, reps=3)   # tools/bench_incoherent_torch.py
WHITTED_TOL, WHITTED_SHARE = 1e-3, 0.02   # tests/test_torch_whitted.py
HUGE_MESH = "huge_mesh.obj"
HUGE_MIN_TRIS = 1_000_000
LBVH_CHECK = dict(width=64, height=64, spp=2, max_depth=8)
# Fused twins of main-path runs (tag of the unfused run, kernel the fused
# run launches once per round, kernels it must not launch), and the regen
# run of bench.py's frame.
FUSED_TWINS = [
    (BENCH_TAG, "closest_nee_lean_tree",
     ("closest_lean", "closest_lean_tree", "occluded", "closest_full",
      "closest_nee_lean")),
    (SPHERE_TAG, "closest_nee_full",
     ("closest_full", "occluded", "closest_lean", "closest_full_tree",
      "occluded_tree")),
]
# Runs of MAIN_RUNS that launch each of their walks once per round: (the
# walks, the kernels they must never launch, the label of the recorded
# calls' timings against the dense bodies).
_LEAN_BANNED = ("closest_lean", "closest_full", "closest_full_tree",
                "occluded_tree", "closest_nee_lean", "closest_nee_lean_tree")
WALK_RUNS = {
    REFERENCE_TAG: (("closest_lean_tree",), _LEAN_BANNED, "reference"),
    BENCH_TAG: (("closest_lean_tree",), _LEAN_BANNED, "recorded"),
    SPHERE_TAG: (("closest_full_tree", "occluded_tree"),
                 ("closest_full", "occluded", "closest_lean",
                  "closest_lean_tree"), "recorded")}
REGEN_OF = BENCH_TAG
TWIN_RMSE = 0.01         # fused / regen frame against its twin (sRGB)
# The entry points on the card: the CLI render and its resume, a Whitted
# render with --validate, the bench on a short setting, trace_pixel.
CLI_RENDER = ["--width", "128", "--height", "128", "--spp", "8",
              "--depth", "4", "--direct-lighting", "--importance-sampling"]
CLI_WHITTED = ["--width", "64", "--height", "64", "--spp", "2",
               "--depth", "4", "--validate", "--stats"]
BENCH_SHORT = dict(BENCH_SIZE="256", BENCH_SPP="4", BENCH_FRAMES="2")
TRACE = dict(width=32, height=32, spp=1, max_depth=4, fused_nee=True,
             use_direct_lighting=True, use_importance_sampling=True)
# CPU (plain versions) vs card (kernels) big-mesh frame, and its bound
# (tests/test_torch_render.py).
CROSS_CHECK = dict(width=32, height=32, spp=2, max_depth=4)
PIXEL_TOL, PIXEL_SHARE = 1e-4, 0.01
# Multi-GPU (phase 35): the forest through the sharded step, the bound of
# a sharded frame against the single-device one where two single-device
# runs on the card already differ (tests/test_dist.py:55), and the 4K
# radiance that the spp group all-reduces (tools/bench_dist_torch.py).
DIST_FOREST = dict(WHITTED_BENCH, width=256, height=256, spp=2)
DIST_TOL = 1e-5
DIST_RADIANCE = (3840 * 2160, 3)
# The native host library (phase 36): the OBJs whose native parse is held
# against the Python one (the three Cornell boxes of tests/test_native.py,
# then the big and the huge mesh under build/assets).
NATIVE_OBJS = [ASSETS / "cornell_box.obj", ASSETS / "cornell_box_mixed.obj",
               ASSETS / "cornell_box_sphere.obj", BUILD_ASSETS / BIG_MESH,
               BUILD_ASSETS / HUGE_MESH]
# The viewer (phase 37): ``cli view`` headless on the reference launch
# (the mixed box, 512^2 x 128 spp, depth 4, IS + NEE) and on the forest at
# the Whitted bench's size, each against the same frames of the plain
# entry point.
VIEW_RUNS = [
    ("mixed box", "cornell_box_mixed.obj", 3,
     ["--width", "512", "--height", "512", "--spp", "128", "--depth", "4",
      "--direct-lighting", "--importance-sampling"],
     ("closest_lean_tree", "occluded")),
    ("forest", FOREST, 2,
     ["--width", "512", "--height", "512", "--spp", "8", "--depth", "8"],
     ("closest_inst", "occluded_inst")),
]
# tools/convergence_torch.py (phase 38) at its full size and samples per
# frame, its frame counts cut from 64 + 16 to fit this run's time.
CONVERGENCE = dict(size=256, spp=16, ref_frames=8, frames=4)
# Phase 39: the RNG at the flagship box's wavefront width, and each
# draw's bytes a lane as the main path calls it: the per-lane counters
# read (8 bytes each) and the used floats written (4 bytes each).
RNG_LANES = 8_388_608
RNG_DRAWS = (  # (name, per-lane counters, floats written, how the path calls it)
    ("bounce_uniforms", 3, 6, "pixelq's _bounce: pixel, sample, depth"),
    ("uniform2", 2, 2, "pixelq's jitter: pixel, sample"),
    ("uniform4", 1, 4, "scan and Whitted: pixel; sample an int"),
)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say("device", f"{name} (sm_{cap[0]}{cap[1]}), "
        f"{torch.cuda.device_count()} visible; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, not sm_{cap}")
    return torch.device("cuda:0"), smi


def phase_build():
    from tpu_pt_torch import _kernels, native
    t0 = time.perf_counter()
    libs = _kernels.build()
    _kernels._entry_points()
    say("build", f"{len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
    # The native host library (g++): the smoke run never falls back to the
    # Python paths.
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native host library did not build (g++): "
                           f"{native.library_path()}")
    say("build", f"native host library {native.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        usage = [ln.strip() for ln in (log.read_text().splitlines()
                                       if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        say("build", f"{lib.name}: " + " | ".join(usage))


def _rng_counters(n_lanes: int, per_lane: int, device, seed: int):
    """Counters of one draw (pixel, sample, frame, stream or depth): the
    first ``per_lane`` per-lane int64 tensors over +-2^40 (past 2^32 and
    negative), the rest ints at the uint32 edges."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    lanes = [torch.randint(-2 ** 40, 2 ** 40, (n_lanes,), generator=gen,
                           device=device, dtype=torch.int64)
             for _ in range(per_lane)]
    return lanes + [2 ** 32 - 1, 2 ** 31 + 7, -3][:4 - per_lane]


def phase_rng(device, smi):
    """Each draw of the RNG kernel bitwise against the plain int64 version
    on the same counters on the card, timed back to back; returns one
    record a draw."""
    import torch
    from tpu_pt_torch import rng
    device_ms = _tool("dense_ab_torch").device_ms

    def plain(name, counters):
        if name == "bounce_uniforms":
            *head, depth = counters
            sa, sb = rng.bounce_streams(depth)
            return (rng.pcg4d(*head, sa)[:3] + rng.pcg4d(*head, sb)[:3])
        return rng.pcg4d(*counters)[:int(name[-1])]

    rows = []
    for seed, (name, per_lane, floats, how) in enumerate(RNG_DRAWS):
        counters = _rng_counters(RNG_LANES, per_lane, device, seed)
        if name == "bounce_uniforms":   # depth: a lane's bounce, 0..8
            counters[-1] = counters[-1] % 9
        draw = getattr(rng, name)
        got = draw(*counters)
        want = [rng._to_unit_float(u) for u in plain(name, counters)]
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(f"rng {name}: output {i} differs from "
                                     f"the plain version in {bad} lanes")
        del got, want
        ms = device_ms(lambda: draw(*counters), 20)
        plain_ms = gpu_ms(lambda: plain(name, counters), 3)
        nbytes = RNG_LANES * (8 * per_lane + 4 * floats)
        bound = _bound(0.0, nbytes)
        rows.append(dict(name=name, route="cuda",
                         source="tpu_pt_torch/csrc/rng.cu", replaces=None,
                         lanes=RNG_LANES, called_as=how, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound["bound_ms"],
                         bound_by=bound["bound_by"], bytes=nbytes,
                         max_abs_err=0.0, library_ms=None))
        say("rng", f"{name} at {RNG_LANES:,} lanes ({how}): bitwise; "
            f"{ms:.4f} ms (bound {bound['bound_ms']:.4f} ms, "
            f"{100 * bound['bound_ms'] / ms:.1f}%), plain {plain_ms:.3f} ms; "
            f"{smi}")
        torch.cuda.empty_cache()
    return rows


def phase_assets(device):
    """Write the big mesh under build/assets and load it onto the card
    (load_scene builds the balanced-kd cluster order with
    median_split_order)."""
    import tpu_pt_torch as tp
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "tools" / "make_assets.py"),
                    "--big", "--out", str(BUILD_ASSETS)], check=True,
                   capture_output=True, timeout=600)
    t1 = time.perf_counter()
    scene = tp.load_scene(str(BUILD_ASSETS / BIG_MESH), device=device)
    t2 = time.perf_counter()
    say("assets", f"{BIG_MESH}: {scene.num_tris} triangles "
        f"({scene.num_tris_padded} padded, {scene.num_occluders} NEE "
        f"occluders); written in {t1 - t0:.2f} s, load_scene incl. "
        f"median_split_order {t2 - t1:.2f} s")
    return scene


def _phase3_rays(scene, device, seed: int, rows, closest, n_rays: int):
    """n_rays rays on the card: camera rays through jittered pixels of a
    2h x h grid, then as many leaving the surfaces ``closest(o, d) ->
    (t, packed row of rows)`` hits, in random directions; plus shadow rays
    from those points to the light."""
    import numpy as np
    import torch
    from tpu_pt_torch import cornell_default_camera, rng
    from tpu_pt_torch.render import CameraArrays, camera_rays
    half = n_rays // 2
    h = int(round((half // 2) ** 0.5))
    cam = CameraArrays.from_camera(cornell_default_camera(), device=device)
    pix = torch.arange(half, device=device)
    jx, jy = rng.uniform2(pix, 0, seed, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, 2 * h, h, jx, jy)
    t, row = closest(o, d)
    hit = (t < 1e15)[:, None]
    nrm = rows[row.long(), 0:3]
    nrm = torch.where((nrm * d).sum(1, keepdim=True) > 0, -nrm, nrm)
    p = torch.where(hit, o + d * t[:, None] + 1e-3 * nrm, o)
    r = np.random.default_rng(seed)
    rd = torch.as_tensor(r.normal(size=(half, 3)).astype(np.float32),
                         device=device)
    rd = torch.where((rd * nrm).sum(1, keepdim=True) < 0, -rd, rd)
    rd = rd / rd.norm(dim=1, keepdim=True)
    lab = torch.as_tensor(r.random((n_rays, 2)).astype(np.float32),
                          device=device)
    light = scene.light
    lp = light.corner + light.v1 * lab[:, :1] + light.v2 * lab[:, 1:]
    sp = torch.cat([p, p])
    to_l = lp - sp
    dist = to_l.norm(dim=1)
    shadow = (sp.contiguous(), (to_l / dist[:, None]).contiguous(),
              (dist - 0.01).contiguous())
    return torch.cat([o, p]).contiguous(), torch.cat([d, rd]).contiguous(), \
        shadow


def _compare_closest(name, kernel_out, plain_out):
    """Kernel vs plain closest hit: equal hit/miss, t within TOL_T, rows
    equal on >= ROW_AGREE of rays (a mismatch must be a tie within TOL_T),
    equal attributes where the rows agree, nothing non-finite. Returns
    (max |dt|, note)."""
    import torch
    t_k, row_k = kernel_out[0], kernel_out[1]
    t_p, row_p = plain_out[0], plain_out[1]
    for x in kernel_out:
        if x.is_floating_point() and not torch.isfinite(x).all():
            raise AssertionError(f"{name}: NaN or Inf in the kernel output")
    hit_k, hit_p = t_k < 1e15, t_p < 1e15
    if not torch.equal(hit_k, hit_p):
        raise AssertionError(f"{name}: hit/miss differs on "
                             f"{int((hit_k != hit_p).sum())} rays")
    max_dt = float((t_k - t_p).abs().max())
    if max_dt > TOL_T:
        raise AssertionError(f"{name}: max |dt| {max_dt} > {TOL_T}")
    same_row = row_k == row_p
    if float(same_row.float().mean()) < ROW_AGREE:
        raise AssertionError(f"{name}: rows agree on only "
                             f"{float(same_row.float().mean()):.6f}")
    for k_out, p_out, what in zip(kernel_out[2:], plain_out[2:],
                                  ("normal", "mat", "u", "v")):
        mask = same_row if k_out.dim() == 1 else same_row[:, None]
        if not bool(((k_out == p_out) | ~mask).all()):
            raise AssertionError(f"{name}: {what} differs on rays with the "
                                 "same winning row")
    return max_dt, f"{int((~same_row).sum())} row ties"


def _compare_exact(name, kernel_out, plain_out):
    """Kernel vs plain, bit for bit on every output: occlusion flags, or
    closest hits (after the checks of _compare_closest)."""
    import torch
    if isinstance(kernel_out, torch.Tensor):
        err = 0.0
        extra = f"{float(kernel_out.float().mean()):.4f} occluded"
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    else:
        err, extra = _compare_closest(name, kernel_out, plain_out)
    for k, p in zip(kernel_out, plain_out):
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: kernel and plain differ on "
                                 f"{int((k != p).sum())} values")
    return err, extra + ", bitwise equal"


def _compare_fused(name, kernel_out, plain_out):
    """Fused kernel vs plain: the closest-hit outputs bit for bit (after
    the checks of _compare_closest), the occlusion flag bit for bit on hit
    lanes (on a miss lane it is meaningless), and every flag a 0 or 1
    byte (a lane left unwritten would hold anything)."""
    import torch
    occ_k, occ_p = kernel_out[-1], plain_out[-1]
    err, extra = _compare_exact(name, kernel_out[:-1], plain_out[:-1])
    if int(occ_k.view(torch.uint8).max()) > 1:
        raise AssertionError(f"{name}: occlusion flags other than 0 / 1")
    hit = kernel_out[0] < 1e15
    bad = int((hit & (occ_k != occ_p)).sum())
    if bad:
        raise AssertionError(f"{name}: occlusion differs on {bad} hit lanes")
    miss_diff = int((~hit & (occ_k != occ_p)).sum())
    return err, (f"{extra}; occlusion bitwise on {int(hit.sum())} hit lanes"
                 f" ({float(occ_k[hit].float().mean()):.4f} occluded), "
                 f"{miss_diff} of {int((~hit).sum())} miss lanes differ")


def _compare_lists(name, kernel_out, plain_out):
    """The list build against stream_candidates: cand, keys, cnt and far
    equal (torch.equal: a key of -0.0 equals one of +0.0, as torch.sort
    compares them)."""
    import torch
    for what, k, p in zip(("cand", "keys", "cnt", "far"), kernel_out,
                          plain_out):
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: {what} differs on "
                                 f"{int((k != p).sum())} values")
    return 0.0, (f"{float(kernel_out[2].float().mean()):.1f} of "
                 f"{kernel_out[0].shape[1]} boxes listed a tile, "
                 "bitwise equal")


def _compare_schedule(name, kernel_out, plain_out):
    """The pair schedule built on the card against ``_pair_schedule``:
    ``tile_sid``, ``next_tn``, ``overflow`` and the used slots equal, and
    each cluster's run the same set of rays (the kernel places a run's
    pairs in the order of its atomics; the fold does not depend on it)."""
    import torch
    for what in ("tile_sid", "next_tn", "overflow"):
        k, p = getattr(kernel_out, what), getattr(plain_out, what)
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: {what} differs on "
                                 f"{int((k != p).sum())} values")
    used_k, used_p = kernel_out.pair_ray >= 0, plain_out.pair_ray >= 0
    if not torch.equal(used_k, used_p):
        raise AssertionError(f"{name}: the used slots differ")
    tile = kernel_out.tile
    run = kernel_out.tile_sid.long().repeat_interleave(tile)
    n = kernel_out.next_tn.shape[0] + 1

    def runs(s):
        return torch.sort(run * n + s.pair_ray.long() + 1).values
    if not torch.equal(runs(kernel_out), runs(plain_out)):
        raise AssertionError(f"{name}: a cluster's run holds other rays")
    return 0.0, (f"{int(used_k.sum())} pairs in "
                 f"{int(used_k.view(-1, tile).any(1).sum())} live tiles of "
                 f"{tile}; tile_sid, next_tn, overflow bitwise, each run "
                 "the same set")


def _compare_cbin_schedule(name, kernel_out, plain_out):
    """K13's schedule built on the card against ``_cbin_schedule``:
    ``jtab``, ``incomplete`` and the meta equal, the used slots the same,
    and each cluster's run the same set of groups (the kernel places a
    run's groups in the order of its atomics; the fold does not depend on
    it); but for the last job's cluster, whose run the pair budget may cut:
    which of its groups keep a slot is not defined, so there the sets may
    differ only if every group in either is incomplete."""
    import torch
    if (kernel_out.meta, kernel_out.rt) != (plain_out.meta, plain_out.rt):
        raise AssertionError(f"{name}: meta {kernel_out.meta} / jobs of "
                             f"{kernel_out.rt}, not {plain_out.meta} / "
                             f"{plain_out.rt}")
    for what in ("jtab", "incomplete"):
        k, p = getattr(kernel_out, what), getattr(plain_out, what)
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: {what} differs on "
                                 f"{int((k != p).sum())} values")
    used = kernel_out.slot_group >= 0
    if not torch.equal(used, plain_out.slot_group >= 0):
        raise AssertionError(f"{name}: the used slots differ")
    ng, g, _ = kernel_out.meta
    jtab = kernel_out.jtab.long()
    run = jtab.repeat_interleave(kernel_out.rt // g)
    last = int(jtab[-1]) if jtab.numel() else -1

    def groups(s, where):
        return torch.sort(run[where] * (ng + 1)
                          + s.slot_group.long()[where] + 1).values
    if not torch.equal(groups(kernel_out, run != last),
                       groups(plain_out, run != last)):
        raise AssertionError(f"{name}: a cluster's run holds other groups")
    cut = ""
    if last >= 0 and not torch.equal(groups(kernel_out, run == last),
                                     groups(plain_out, run == last)):
        held = torch.cat([s.slot_group[run == last]
                          for s in (kernel_out, plain_out)]).long()
        held = held[held >= 0]
        if not bool(kernel_out.incomplete.view(ng, g)[held, 0].all()):
            raise AssertionError(f"{name}: the cut run of cluster {last} "
                                 "holds complete groups the two place "
                                 "apart")
        cut = f"; the budget's cut run (cluster {last}) differs, all incomplete"
    return 0.0, (f"{int(used.sum())} group-pairs in "
                 f"{int((jtab >= 0).sum())} jobs of {kernel_out.rt}, "
                 f"{float(kernel_out.incomplete.float().mean()):.4f} of lanes "
                 f"incomplete; jtab, incomplete bitwise, each run the same "
                 f"set{cut}")


def _park(rays, shadow, every: int):
    """Park every ``every``-th lane as the wavefront parks retired lanes
    and ineligible shadow rays (render.py): origin PARK_COORD, direction
    PARK_DIR, shadow tmax 0."""
    import torch
    from tpu_pt_torch.render import PARK_COORD, PARK_DIR
    o, d = rays
    so, sd, st = shadow
    park = (torch.arange(o.shape[0], device=o.device) % every == 0)[:, None]

    def org(x):
        return torch.where(park, PARK_COORD, x).contiguous()

    def dirs(x):
        return torch.where(park, PARK_DIR, x).contiguous()
    return (org(o), dirs(d)), (org(so), dirs(sd),
                               torch.where(park[:, 0], 0.0, st).contiguous())


def _kernel_module(name: str):
    """The intersect module whose wrapper ``name`` is."""
    from tpu_pt_torch.intersect import ablations, clustered, dense, instanced
    return next(m for m in (dense, clustered, instanced, ablations)
                if name in m.LAUNCHES)


class _Tap:
    """Keeps the arguments of one call of each named kernel wrapper on
    each table it is handed, while the wrappers run as usual: the first
    call in which at least one lane in PARK_EVERY is parked and some lane
    is live, else the first with a live lane, else the first call.
    ``picked[(name, tables)]`` is (args, parked share), where
    ``tables`` are the data pointers of the call's 2-D table arguments (a
    wrapper swept over two tables, such as K9 over an instanced scene's
    main and alpha-subset tables, is kept once for each), and for the list
    build its tile too (one call at each tile)."""

    def __init__(self, names):
        self.names, self.picked = tuple(names), {}

    def __enter__(self):
        import torch
        from tpu_pt_torch.render import PARK_COORD
        self.saved = {k: getattr(_kernel_module(k), k) for k in self.names}

        def rank(parked):
            return (parked < 1.0) + (1.0 / PARK_EVERY <= parked < 1.0)

        def keep(a):
            if isinstance(a, tuple):        # K12's lists, K13's schedule
                out = [keep(x) for x in a]
                return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
            return a.clone() if torch.is_tensor(a) else a

        def tap(name, wrapper):
            def call(*args):
                parked = float((args[0][:, 0] == PARK_COORD).float().mean())
                key = (name, tuple(a.data_ptr() for a in args[2:]
                                   if torch.is_tensor(a) and a.dim() == 2)
                       + ((args[3],) if name == "stream_lists" else ()))
                old = self.picked.get(key)
                if old is None or rank(old[1]) < rank(parked):
                    self.picked[key] = (tuple(keep(a) for a in args), parked)
                return wrapper(*args)
            return call
        for k, fn in self.saved.items():
            setattr(_kernel_module(k), k, tap(k, fn))
        return self

    def __exit__(self, *exc):
        for k, fn in self.saved.items():
            setattr(_kernel_module(k), k, fn)


def _record_big_calls(big, device):
    """The arguments of one K6 and one K8 call of a bench_big frame (frame
    0, IS + NEE): for each wrapper a call in which at least one lane in
    PARK_EVERY is parked, so the set holds live and parked lanes."""
    names = ("closest_clustered", "occluded_clustered")
    with _Tap(names) as tap:
        _render(big, device, [0], use_direct_lighting=True,
                use_importance_sampling=True, **BENCH_BIG)
    for name in names:
        if not any(k[0] == name and parked >= 1.0 / PARK_EVERY
                   for k, (_, parked) in tap.picked.items()):
            raise AssertionError(f"no {name} call of the bench_big frame "
                                 "had parked lanes")
    return tap.picked


def _plain(name: str, args):
    """The plain version of wrapper ``name`` on a wrapper call's own
    positional arguments."""
    from tpu_pt_torch.intersect import ablations, clustered, dense, instanced
    if name == "closest_rotated":
        o, d, tris, _, _, pred, slab_rows, tmin, *tmax = args
        return ablations._closest_rotated_plain(o, d, tris, pred, slab_rows,
                                                tmin, *tmax)
    if name == "closest_streamed":
        rays, tris, boxes, scale, lists, rt, tmin, tmax, guard = args
        return ablations._streamed_plain(rays, tris, boxes, scale, lists, rt,
                                         tmin, tmax, guard, occluded=False)
    if name == "occluded_streamed":
        rays, tris, boxes, scale, lists, rt, tmin, guard = args
        return ablations._streamed_plain(rays, tris, boxes, scale, lists, rt,
                                         tmin, 1e16, guard, occluded=True)
    if name == "stream_lists":
        return ablations.stream_candidates(*args)
    if name == "pair_schedule":
        return ablations._pair_schedule(*args)
    if name == "cbin_schedule":
        return ablations._cbin_schedule(*args)
    if name in ("closest_cbin", "occluded_cbin"):
        return ablations._cbin_fold_plain(*args,
                                          occluded=name == "occluded_cbin")
    if name == "closest_binned":
        return ablations._reduce_pairs(
            *ablations._binned_sweep_plain(*args, occluded=False),
            args[0].shape[0])
    if name == "occluded_binned":
        return ablations._reduce_pairs_occ(
            *ablations._binned_sweep_plain(*args, occluded=True),
            args[0].shape[0])
    if name == "closest_grp":
        rays, tris, boxes, scale, lists, tmin, tmax, _ = args
        return ablations._grp_plain(rays, tris, boxes, scale, lists, tmin,
                                    tmax, occluded=False)
    if name == "occluded_grp":
        rays, tris, boxes, scale, lists, tmin, _ = args
        return ablations._grp_plain(rays, tris, boxes, scale, lists, tmin,
                                    1e16, occluded=True)
    if name == "closest_lean":
        o, d, tris, tmin = args
        return dense._closest_plain(o, d, tris, tmin)
    if name == "closest_full":
        o, d, tris, tmin, tmax, want_uv = args
        return dense._closest_plain(o, d, tris, tmin, tmax, True, want_uv)
    if name == "occluded":
        return dense._occluded_plain(*args)
    if name == "closest_full_tree":
        o, d, rows, _, _, _, _, tmin, tmax, want_uv = args[:10]
        return dense._closest_full_kd_plain(o, d, rows, tmin, tmax, want_uv)
    if name == "occluded_tree":
        o, d, tmax, rows, _, _, _, _, tmin = args[:9]
        return dense._occluded_kd_plain(o, d, tmax, rows, tmin)
    if name == "closest_nee_lean":
        return dense._closest_nee_plain(*args)
    if name == "closest_lean_tree":
        o, d, rows, _, _, _, _, tmin = args[:8]
        return dense._closest_lean_kd_plain(o, d, rows, tmin)
    if name == "closest_nee_lean_tree":
        o, d, lz1, lz2, rows, *_ = args
        occ_rows, light, tmin = args[9], args[14], args[15]
        return dense._closest_nee_lean_kd_plain(o, d, lz1, lz2, rows,
                                                occ_rows, light, tmin)
    if name == "closest_nee_full":
        o, d, lz1, lz2, rows, _, _, _, _, light, tmin, tmax = args[:12]
        return dense._closest_nee_kd_plain(o, d, lz1, lz2, rows, light, tmin,
                                           tmax)
    # K6, K6f and K8 take the node table last.
    if name in CLOSEST_K6:
        o, d, rows, _, _, tmin, *rest = args
        return clustered._closest_clustered_plain(o, d, rows, tmin,
                                                  *rest[:1])
    if name in CLOSEST_K6F:
        o, d, rows, _, _, tmin, *rest = args
        return clustered._closest_clustered_full_plain(o, d, rows, tmin,
                                                       *rest[:2])
    if name in OCCLUDED_K8:
        o, d, tmax, rows, _, _, tmin = args[:7]
        return clustered._occluded_clustered_plain(o, d, tmax, rows, tmin)
    if name == "closest_inst":
        # K9 takes the instance tree after tmax.
        o, d, tris, _, _, inst_rows, _, tmin, *tmax = args
        return instanced._closest_inst_plain(o, d, tris, clustered.CLUSTER,
                                             inst_rows, tmin, *tmax[:1])
    # K10 takes the instance tree and the width after tmin.
    o, d, tmax, tris, _, _, inst_rows, _, tmin = args[:9]
    return instanced._occluded_inst_plain(o, d, tmax, tris, clustered.CLUSTER,
                                          inst_rows, tmin)


def _hold_recorded(records, picked, what: str, all_parked_ok=()):
    """Each recorded wrapper call against its plain version on the same
    arguments, bit for bit; appends a record per call. A call whose lanes
    are all parked is refused, but for the wrappers of ``all_parked_ok``
    (K13's completion pass has live lanes only where a cap overflowed)."""
    import torch
    for (name, _), (args, parked) in picked.items():
        if parked >= 1.0 and name not in all_parked_ok:
            raise AssertionError(f"{name}: every recorded {what} call on a "
                                 "table had all its lanes parked")
        out_k = getattr(_kernel_module(name), name)(*args)
        out_p = _plain(name, args)
        torch.cuda.synchronize()
        compare = (_compare_fused if name.startswith("closest_nee")
                   else _compare_lists if name == "stream_lists"
                   else _compare_schedule if name == "pair_schedule"
                   else _compare_cbin_schedule if name == "cbin_schedule"
                   else _compare_exact)
        err, extra = compare(name, out_k, out_p)
        # The tables follow the rays: (o, d, rows, ...), or (rays, rows,
        # ...) for the wrappers that take packed [n, 8] rays.
        first = 1 if args[0].shape[-1] == 8 else 2
        tables = [tuple(a.shape) for a in args[first:]
                  if torch.is_tensor(a) and a.dim() == 2]
        records.setdefault(name, []).append(dict(
            rows=tables[0][0] if tables else args[1].shape[0],
            rays=args[0].shape[0], max_abs_err=err))
        say("kernels", f"{name}: a {what} call, its own {args[0].shape[0]} "
            f"rays ({parked:.4f} parked) on tables {tables}: max|err| {err}"
            f" ({extra})")


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for this work (ms), and which
    rate sets it."""
    ops_ms, bytes_ms = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _dense_work(o, rows, out_bytes: int):
    """A closest-hit sweep needs every (ray, row) pair: each row could be
    nearer. Bytes: rays in, the table, ``out_bytes`` per ray out."""
    n, r = o.shape[0], rows.shape[0]
    return n * r * PAIR_FLOPS, n * 24 + r * 64 + n * out_bytes


def _dense_occluded_work(o, d, tmax, rows, tmin: float = 0.01):
    """An any-hit sweep in row order needs, per ray, the rows up to its
    first blocking one, or every row when nothing blocks; none for a ray
    whose range (tmin, tmax) is empty (a parked lane's tmax is 0), unless
    tmax is past T_FAR, where a miss blocks."""
    import torch
    from tpu_pt_torch.intersect import dense
    n, r = o.shape[0], rows.shape[0]
    pairs = 0
    for a in range(0, n, 16384):
        tm = tmax[a:a + 16384]
        t, _, _ = dense._pe_block(o[a:a + 16384], d[a:a + 16384], rows, tmin)
        block = (t < tm[:, None]) & (rows[None, :, 13] < 0.5)
        first = block.to(torch.int32).argmax(1)
        need = torch.where(block.any(1), first + 1, r)
        empty = ~(tm > tmin) & ~(tm > dense.T_FAR)
        pairs += int(torch.where(empty, 0, need).sum())
    return pairs * PAIR_FLOPS, n * 28 + r * 64 + n


def _split_occluded_work(o, d, tmax, rows, tmin: float = 0.01):
    """The work of K2's culled sweep (``dense.occluded`` from
    OCC_SPLIT_MIN_RAYS rays) on these rays: its pair tests
    (``dense._occluded_split_plain``: the rows every ray sweeps up to the
    first blocking one, all rows of each group a ray meets) and its box
    tests. Bytes as _dense_occluded_work, the split's rows for the
    table's."""
    from tpu_pt_torch.intersect import dense
    split = dense.row_split(rows)
    _, pairs, boxes = dense._occluded_split_plain(o, d, tmax, rows, split,
                                                  tmin, counts=True)
    n = o.shape[0]
    return (pairs * PAIR_FLOPS + boxes * BOX_FLOPS,
            n * 28 + split.rows.shape[0] * 64 + n)


def _slab_pass(o, d, lo, hi, m, tmin: float, bound):
    """The kernels' slab test (pe_block.cuh): [R] rays x [B] boxes
    (lo, hi [B, 3]) grown by m ([R] or [R, B]); does the parameter
    interval meet (tmin, bound[r]]?"""
    import torch
    g = torch.where(d.abs() > 1e-12, d,
                    torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype))
    inv = (1.0 / g)[:, None]
    m = (m if m.dim() == 2 else m[:, None])[..., None]
    t0 = (lo[None] - m - o[:, None]) * inv
    t1 = (hi[None] + m - o[:, None]) * inv
    tn = torch.minimum(t0, t1).amax(2)
    tf = torch.maximum(t0, t1).amin(2)
    return (tn <= tf) & (tf > tmin) & (tn <= bound[:, None])


def _clustered_work(o, d, bound, rows, boxes, scale, out_bytes: int,
                    occluded=None, box_tests=None, list_bytes: int = 0):
    """A clustered traversal needs one slab test per (ray, box) and the
    rows of every box the ray pierces up to ``bound`` (its closest hit,
    or its shadow tmax); an occluded shadow ray needs one box's rows. A
    kernel handed a work list tests ``box_tests`` (ray, box) pairs, not
    all of them, and reads ``list_bytes`` of lists besides."""
    import torch
    from tpu_pt_torch.intersect import clustered
    n, c = o.shape[0], boxes.shape[0]
    pierced = 0
    for a in range(0, n, 4096):
        m = clustered.BOX_MARGIN * (scale + o[a:a + 4096].abs().amax(1))
        cnt = _slab_pass(o[a:a + 4096], d[a:a + 4096], boxes[:, 0:3],
                         boxes[:, 3:6], m, 0.01, bound[a:a + 4096]).sum(1)
        if occluded is not None:
            cnt = torch.where(occluded[a:a + 4096], cnt.clamp_max(1), cnt)
        pierced += int(cnt.sum())
    cluster = rows.shape[0] // c
    tests = n * c if box_tests is None else box_tests
    flops = tests * BOX_FLOPS + pierced * cluster * PAIR_FLOPS
    return flops, n * (24 + (4 if occluded is not None else 0)) \
        + rows.shape[0] * 64 + c * 32 + n * out_bytes + list_bytes


def _list_work(rays8, boxes, lists, rt: int, occluded: bool):
    """The list build's own work (``stream_lists``): a slab test of every
    (ray, box) pair, and a comparison sort of each tile's listed boxes
    (cnt log2 cnt comparisons, one operation each). Bytes: the packed
    rays (and their tmax for the any-hit) and the boxes in; cand and keys
    (8 bytes a tile and box), cnt and far out."""
    import math
    n, c = rays8.shape[0], boxes.shape[0]
    sort_ops = sum(k * math.log2(k) for k in lists[2].tolist() if k > 1)
    return n * c * BOX_FLOPS + sort_ops, \
        n * (32 + (4 if occluded else 0) + 4) + c * 32 + n // rt * (c * 8 + 4)


def _cbin_work(rays, rows, schedule, cluster: int, occluded: bool):
    """K13's own work, from the wrappers' inputs: every live pair lane (a
    used slot of a job with a cluster, its ray not parked) against its
    job's rows, all of them for the closest hit, up to the first blocking
    one for the any-hit; no slab test (those ran in the schedule). Bytes:
    the used slots, the job table and the live lanes' rays in, each
    distinct cluster's rows once, 8 (t, row) or 1 byte per ray out."""
    import torch
    from tpu_pt_torch.intersect import ablations
    jtab, rt = schedule.jtab, schedule.rt
    j_cap = jtab.shape[0]
    ray, pair_rays = ablations._cbin_pair_rays(rays, schedule)
    live = (((jtab >= 0)[:, None] & (ray.view(j_cap, rt) >= 0)).view(-1)
            & (pair_rays[:, 0] < 1e7))
    pairs = int(live.sum()) * cluster
    if occluded:
        pairs = 0
        for j0 in range(0, j_cap, 256):
            jt = jtab[j0:j0 + 256]
            pr = pair_rays[j0 * rt:(j0 + 256) * rt].view(-1, rt, 8)
            blk = rows.view(-1, cluster, 16)[jt.clamp_min(0).long()]
            t = ablations._pe_rows(pr[:, :, 0:3], pr[:, :, 3:6], blk, 0.01)
            block = (t < pr[:, :, 6:7]) & (blk[:, None, :, 13] < 0.5)
            first = block.to(torch.int32).argmax(2)
            need = torch.where(block.any(2), first + 1, cluster)
            pairs += int(need.view(-1)[live[j0 * rt:(j0 + 256) * rt]].sum())
    used = int(torch.unique(jtab[jtab >= 0]).numel())
    return pairs * PAIR_FLOPS, int((schedule.slot_group >= 0).sum()) * 4 \
        + j_cap * 4 + int(live.sum()) * 32 + used * cluster * 64 \
        + rays.shape[0] * (1 if occluded else 8)


def _cbin_schedule_work(rays, boxes, scale, schedule):
    """K13's schedule's own work: its lists' group tests, one slab test's
    operations each (every (group, box) for the flat interval lists, every
    (ray, box) for the exact union; every (group, parent), then the kept
    parents' children, for the two-level lists, the kept ones counted by
    the plain parent test on these rays). Bytes: the rays and boxes in;
    jtab, the slots and the incomplete flags out."""
    import torch
    from tpu_pt_torch.intersect import ablations
    ng, g, _ = schedule.meta
    ns = boxes.shape[0]
    if ablations._cbin_two_level(g, ns):
        fan = ablations.CBIN_FAN
        n_par = -(-ns // fan)
        k1 = min(ablations.CBIN_K1, max(1, n_par))
        pad = n_par * fan - ns
        lo = torch.nn.functional.pad(boxes[:, 0:3], (0, 0, 0, pad),
                                     value=3e38).view(n_par, fan, 3).amin(1)
        hi = torch.nn.functional.pad(boxes[:, 3:6], (0, 0, 0, pad),
                                     value=-3e38).view(n_par, fan, 3).amax(1)
        bounds = ablations._cbin_ray_bounds(rays, scale, g)
        kept = ablations._interval_slab(bounds, lo[None], hi[None], 0.01).sum(
            1).clamp_max(k1)
        tests = ng * n_par + int(kept.sum()) * fan
    elif g > 1 and ablations._cbin_exact():
        tests = rays.shape[0] * ns
    else:
        tests = ng * ns
    return tests * BOX_FLOPS, rays.numel() * 4 + boxes.numel() * 4 \
        + schedule.jtab.numel() * 4 + schedule.slot_group.numel() * 4 \
        + rays.shape[0]


def _binned_work(rays, rows, schedule, cluster: int, occluded: bool):
    """K14's own work, from the wrapper's inputs: every used pair slot of
    a live tile against its tile's rows, all of them for the closest hit,
    up to the first blocking one for the any-hit; no slab test (those ran
    in the schedule build). Padding slots and dead tiles are no work.
    Bytes: the rays, the used slots and the live tiles' entries in, each
    distinct cluster's rows once, one 8-byte key or one flag per ray
    out."""
    import torch
    from tpu_pt_torch.intersect import ablations
    pair_ray, tile_sid, tile = (schedule.pair_ray, schedule.tile_sid,
                                schedule.tile)
    ns = rows.shape[0] // cluster
    live = ((tile_sid < ns)[:, None] & (pair_ray.view(-1, tile) >= 0))
    pairs = int(live.sum()) * cluster
    if occluded:
        pairs = 0
        table = rows.view(ns, cluster, 16)
        step = max(1, 32768 // tile)
        for j0 in range(0, tile_sid.shape[0], step):
            sid = tile_sid[j0:j0 + step].long().clamp_max(ns - 1)
            lv = live[j0:j0 + step]
            pr = rays[pair_ray.view(-1, tile)[j0:j0 + step]
                      .long().clamp_min(0)]
            blk = table[sid]
            t = ablations._pe_rows(pr[..., 0:3], pr[..., 3:6], blk, 0.01)
            block = (t < pr[..., 6:7]) & (blk[:, None, :, 13] < 0.5)
            first = block.to(torch.int32).argmax(2)
            need = torch.where(block.any(2), first + 1, cluster)
            pairs += int(need[lv].sum())
    used = int(torch.unique(tile_sid[tile_sid < ns]).numel())
    return pairs * PAIR_FLOPS, rays.numel() * 4 + int(live.sum()) * 4 \
        + int(live.any(1).sum()) * 4 + used * cluster * 64 \
        + rays.shape[0] * (1 if occluded else 8)


def _walk_counts(o, d, bound, tb, occluded=None):
    """(node tests, clusters swept, live rays) of the tree walk at each
    ray's final ``bound`` (``clustered._tree_leaves_plain``): the walk's
    own work for these rays. Parked rays test the root only (an any-hit
    ray with an empty interval, none); an occluded shadow ray needs one
    path to one blocking cluster (2 * depth + 1 tests)."""
    import torch
    from tpu_pt_torch.intersect import clustered
    from tpu_pt_torch.render import PARK_COORD
    tests = leaves = 0
    depth = clustered.tree_depth(tb.boxes.shape[0])
    for a in range(0, o.shape[0], 4096):
        sl = slice(a, a + 4096)
        reached, n_tests = clustered._tree_leaves_plain(
            o[sl], d[sl], tb.nodes, tb.boxes, tb.scale, 0.01, bound[sl])
        swept = reached.sum(1)
        if occluded is not None:
            n_tests = torch.where(occluded[sl], 2 * depth + 1, n_tests)
            n_tests = torch.where(bound[sl] > 0.01, n_tests, 0)
            swept = torch.where(occluded[sl], swept.clamp_max(1), swept)
        tests += int(n_tests.sum())
        leaves += int(swept.sum())
    live = int((o[:, 0] != PARK_COORD).sum())
    return tests, leaves, max(live, 1)


def _nodes_kw(fn, nodes) -> dict:
    """``nodes=`` for a walking wrapper (K6, K6f, K8); K7 / K8b take no
    node table."""
    return {} if fn.__name__.endswith("_b") else dict(nodes=nodes)


def _check_kernel(records, name, kernel, plain, rows, compare, work,
                  n=N_RAYS, reps=20, plain_reps=3, at_n_rays=None,
                  label=None):
    """Compare kernel() with plain() on the same n rays and time both;
    ``work(out)`` gives the (operations, bytes) these inputs need;
    ``at_n_rays``, when given, is the kernel on N_RAYS rays, timed too.
    Appends the record to ``records[name]``; ``label`` names the record in
    the log line (default ``name``)."""
    import torch
    out_k = kernel()
    out_p = plain()
    torch.cuda.synchronize()
    err, extra = compare(name, out_k, out_p)
    ms = gpu_ms(kernel, reps)
    plain_ms = gpu_ms(plain, plain_reps)
    rec = dict(rows=rows, rays=n, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, **_bound(*work(out_k)))
    wide = ""
    if at_n_rays is not None:
        rec["ms_at_n_rays"] = gpu_ms(at_n_rays, reps)
        wide = f"; kernel at {N_RAYS} rays {rec['ms_at_n_rays']:.4f} ms"
    records.setdefault(name, []).append(rec)
    say("kernels", f"{label or name} x {rows} rows: max|err| {err} on {n} rays"
        f" ({extra}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at "
        f"{n} rays{wide}; bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: {rec['flops']:.4g} flops, "
        f"{rec['bytes']:.4g} bytes)")


def _check_dense_walks(records, device, sphere, tables):
    """K3's and K2's walks on the sphere box (``closest_full_tree`` over
    its kd copy, ``occluded_tree`` over its occluder subset's), at the
    frame's N_SPHERE_RAYS lanes with one in PARK_EVERY parked and at
    N_RAYS unparked: camera and bounce rays (K3, u and v asked for) and
    shadow rays from their points to the light (K2), each walk bitwise
    against its plain version and against its dense body on the same
    inputs, the two timed in interleaved pairs; the walk's bound from its
    own node tests and reached clusters beside the dense count. Then K3 on
    rays aimed at shared edges, where rows tie on t."""
    import torch
    from tpu_pt_torch.intersect import dense
    kd, occ_kd, rows, occ = (tables.kd, tables.occ_kd, tables.rows,
                             tables.occ_rows)
    if kd is None or occ_kd is None:
        raise AssertionError("the sphere box must have both kd copies")

    def plain_dense(o, d):
        return dense._closest_plain(o, d, rows, 0.01)
    for width, n, park in (("narrow", N_SPHERE_RAYS, True),
                           ("wide", N_RAYS, False)):
        o, d, shadow = _phase3_rays(sphere, device, 14, rows, plain_dense, n)
        if park:
            (o, d), shadow = _park((o, d), shadow, PARK_EVERY)
        so, sd, st = shadow

        def k3(o=o, d=d):
            return dense.closest_full_tree(o, d, kd.rows, kd.top, kd.boxes,
                                           kd.nodes, kd.scale, 0.01, 1e16,
                                           True)

        def k3_dense(o=o, d=d):
            return dense.closest_full(o, d, rows, 0.01, 1e16, True)

        def k2(so=so, sd=sd, st=st):
            return dense.occluded_tree(so, sd, st, occ_kd.rows, occ_kd.top,
                                       occ_kd.boxes, occ_kd.nodes,
                                       occ_kd.scale, 0.01)

        def k2_dense(so=so, sd=sd, st=st):
            return dense.occluded(so, sd, st, occ, 0.01)
        per_ray = {}

        def k3_work(out, o=o, d=d):
            pairs, tests, leaves, live = _closest_walk_work(o, d, out[0], kd)
            per_ray["K3"] = (tests / live, leaves / live, live)
            return (pairs * PAIR_FLOPS + tests * BOX_FLOPS,
                    o.shape[0] * (24 + 32) + _kd_bytes(kd))

        def k2_work(out, so=so, sd=sd, st=st):
            pairs, tests, leaves = _shadow_walk_work(so, sd, st, occ_kd, out)
            live = max(int((st > 0.01).sum()), 1)
            per_ray["K2"] = (tests / live, leaves / live, live)
            return (pairs * PAIR_FLOPS + tests * BOX_FLOPS,
                    so.shape[0] * (28 + 1) + _kd_bytes(occ_kd))
        for name, walk, plain, table, work, dense_work, body in (
                ("closest_full_tree", k3,
                 lambda o=o, d=d: dense._closest_full_kd_plain(
                     o, d, kd.rows, 0.01, 1e16, True), kd,
                 k3_work, lambda o=o: _dense_work(o, rows, 32), k3_dense),
                ("occluded_tree", k2,
                 lambda so=so, sd=sd, st=st: dense._occluded_kd_plain(
                     so, sd, st, occ_kd.rows, 0.01), occ_kd,
                 k2_work, lambda so=so, sd=sd, st=st: _dense_occluded_work(
                     so, sd, st, occ), k2_dense)):
            torch.cuda.synchronize()
            what = "K3" if name == "closest_full_tree" else "K2"
            _check_kernel(records, name, walk, plain, table.rows.shape[0],
                          _compare_exact, work, n=n, reps=10, plain_reps=2,
                          label=f"{name} (sphere box, {width})")
            rec = records[name][-1]
            rec.update(dense_bound_ms=_bound(*dense_work())["bound_ms"],
                       dense_rows=(rows if what == "K3" else occ).shape[0],
                       top_rows=table.top, clusters=table.boxes.shape[0],
                       node_tests_per_ray=per_ray[what][0],
                       clusters_per_ray=per_ray[what][1])
            say("kernels", f"{name} ({what}'s walk), {width}: {table.top} top "
                f"rows and {table.boxes.shape[0]} clusters; a live ray "
                f"({per_ray[what][2]} of {n}) at its final bound tests "
                f"{per_ray[what][0]:.2f} nodes and sweeps "
                f"{per_ray[what][1]:.2f} clusters; bound "
                f"{rec['bound_ms']:.4f} ms against the dense count's "
                f"{rec['dense_bound_ms']:.4f}")
            _walk_against_dense(records, name, f"{what} (sphere box)",
                                walk, body, width)
    # Rays aimed at shared edges: ties that the lowest dense row wins.
    eo, ed = _edge_rays(sphere, N_RAYS // 4, 15, device)
    t_all, _, _ = dense._pe_block(eo[:16384], ed[:16384], rows, 0.01)
    best = t_all.min(1).values
    ties = int((((t_all == best[:, None]).sum(1) > 1) & (best < 1e15)).sum())
    if ties < best.shape[0] // 200:
        raise AssertionError(f"K3 edge rays: only {ties} of {best.shape[0]} "
                             "tie")
    out_w = dense.closest_full_tree(eo, ed, kd.rows, kd.top, kd.boxes,
                                    kd.nodes, kd.scale, 0.01, 1e16, True)
    for what, other in (
            ("plain", dense._closest_full_kd_plain(eo, ed, kd.rows, 0.01,
                                                   1e16, True)),
            ("dense body", dense.closest_full(eo, ed, rows, 0.01, 1e16,
                                              True))):
        torch.cuda.synchronize()
        err, extra = _compare_exact("closest_full_tree", out_w, other)
        say("kernels", f"closest_full_tree: {N_RAYS // 4} rays aimed at "
            f"shared edges ({ties} of the first {best.shape[0]} tie on t), "
            f"walk against the {what}: max|err| {err} ({extra})")
    records["closest_full_tree"].append(dict(
        rows=kd.rows.shape[0], rays=N_RAYS // 4, max_abs_err=0.0))


def _check_ablations(records, tb, rays, shadow, rays_wide, shadow_wide,
                     k6_out, k8_out):
    """K11, K12 and K13 on the big mesh. At N_PLAIN_BIG rays (one lane in
    PARK_EVERY parked): each wrapper bitwise against its plain version on
    the same schedule, timed (the kernel alone; its schedule build apart),
    with the bound of the kernel's own work: K6's / K8's for K11, whose
    function and per-ray work are theirs; for K12 the slab tests of the
    listed boxes only; for K13 its live pair lanes against their clusters
    and no slab test, since those ran in the build. The whole path (build,
    kernel, fold, completion pass) is timed too, beside K6's / K8's
    bound (``path_ms``, ``path_bound_ms``). K12's closest hit at every
    width it is built for, guard on and off, against K6, and against its
    plain version at N_RAYS too; K13's schedule built on the card against
    its plain version and its folded kernels against the reference's
    reduce over ``cbin_pairs``' per-pair results (the lanes that are not
    incomplete) under every cap setting. Then each whole path bitwise
    against K6 / K8 (``k6_out``, ``k8_out``) under every knob setting,
    there and at N_RAGGED rays."""
    import torch
    from tpu_pt_torch.intersect import ablations, clustered
    rows, boxes, scale = tb.rows, tb.boxes, tb.scale
    rt, cluster = (ablations.STREAM_CLOSEST_TILE,
                   rows.shape[0] // boxes.shape[0])
    occ_rt = ablations.STREAM_OCC_TILE
    (o, d), (oW, dW) = rays, rays_wide
    t6, row6 = k6_out
    srows = clustered._clustered_slab_rows(rows.shape[0])
    s_count = -(-rows.shape[0] // srows)
    n = o.shape[0]
    table = (rows, boxes, scale)

    def closest_work(out, **kw):
        return _clustered_work(o, d, t6, rows, boxes, scale, 8, **kw)

    def occluded_work(out, **kw):
        return _clustered_work(*shadow, rows, boxes, scale, 1,
                               occluded=k8_out, **kw)

    def k8_finish(o, d, tmax):
        return clustered.occluded_clustered(o, d, tmax, *table, 0.01,
                                            tb.nodes)

    def streamed_work(lists, whole, lanes=rt):
        """K12 (K15) on ``lists``: slab tests on its tiles' (groups')
        listed boxes only; it reads the listed (box, key) entries, cnt and
        far besides."""
        listed = int(lists[2].sum())
        return lambda out: whole(
            out, box_tests=listed * lanes,
            list_bytes=listed * 8 + n // lanes * 4 + n * 4)

    def run(name, kernel, plain, work, wide, build=None, path=None,
            path_work=None, label=None):
        _check_kernel(records, name, kernel, plain, rows.shape[0],
                      _compare_exact, work, n=n, reps=10, plain_reps=1,
                      at_n_rays=wide, label=label)
        if build is None:
            return
        rec = records[name][-1]
        path()
        rec["build_ms"] = gpu_ms(build, 5)
        rec["path_ms"] = gpu_ms(path, 5)
        whole = _bound(*path_work(None))
        rec["path_bound_ms"], rec["path_bound_by"] = (whole["bound_ms"],
                                                      whole["bound_by"])
        say("kernels", f"{label or name}: its schedule build at {n} rays "
            f"{rec['build_ms']:.4f} ms per call; the whole path "
            f"{rec['path_ms']:.4f} ms beside the function's bound "
            f"{rec['path_bound_ms']:.4f} ms ({rec['path_bound_by']})")

    # K11: the predictions are the unknown one (the fixed order), the
    # oracle (K6's own landing slabs) and a cycled wrong one.
    arange = torch.arange(n, device=o.device)
    preds = {
        "unknown": torch.full((n,), clustered.SLAB_UNKNOWN,
                              dtype=torch.int32, device=o.device),
        "oracle": torch.where(t6 < 1e15, row6 // srows,
                              clustered.SLAB_UNKNOWN).to(torch.int32),
        "cycled": (arange % s_count).to(torch.int32)}
    unknown_w = torch.full((oW.shape[0],), clustered.SLAB_UNKNOWN,
                           dtype=torch.int32, device=o.device)

    def k11(o, d, pred, **kw):
        return ablations.closest_rotated(o, d, *table, pred, srows, 0.01,
                                         **kw)
    run("closest_rotated", lambda: k11(o, d, preds["oracle"]),
        lambda: ablations._closest_rotated_plain(o, d, rows, preds["oracle"],
                                                 srows, 0.01),
        closest_work, lambda: k11(oW, dW, unknown_w))
    for what, pred in preds.items():
        records["closest_rotated"][-1][f"ms_{what}"] = gpu_ms(
            lambda: k11(o, d, pred), 10)
    say("kernels", f"closest_rotated: {s_count} slabs of {srows} rows; ms "
        f"per call under each prediction "
        f"{ {w: round(records['closest_rotated'][-1]['ms_' + w], 4) for w in preds} }")
    # K11 at every width under each prediction: against its plain version
    # (per prediction) and K6; at N_RAYS against K6 (the plain version at
    # that count: phase 22's incoherent rays).
    t_k = time.perf_counter()
    t6W, row6W = clustered.closest_clustered(oW, dW, *table, 0.01,
                                             nodes=tb.nodes)
    cycled_w = (torch.arange(oW.shape[0], device=o.device) % s_count).to(
        torch.int32)
    for what, pred in preds.items():
        plain = ablations._closest_rotated_plain(o, d, rows, pred, srows,
                                                 0.01)
        for g in clustered.GROUPS:
            got = k11(o, d, pred, group=g)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, plain)) \
                    or not (torch.equal(got[0], t6)
                            and torch.equal(got[1], row6)):
                raise AssertionError(
                    f"closest_rotated at {g} lanes a ray, {what} prediction:"
                    " differs from its plain version or K6")
    for pred in (unknown_w, cycled_w):
        for g in clustered.GROUPS:
            got = k11(oW, dW, pred, group=g)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], t6W) and torch.equal(got[1], row6W)):
                raise AssertionError(
                    f"closest_rotated at {oW.shape[0]} rays, {g} lanes a "
                    "ray: differs from K6")
    say("kernels", f"closest_rotated at {clustered.GROUPS} lanes a ray: "
        f"bitwise equal to its plain version and K6 under the {len(preds)} "
        f"predictions at {n} rays, to K6 under the unknown and the cycled "
        f"one at {oW.shape[0]} ({ablations.rotated_group(n)} lanes a ray "
        f"shipped; {time.perf_counter() - t_k:.1f} s)")

    # K12: lists built once (on the card, held against their plain
    # version), the kernel timed alone; the closest side at tiles of rt
    # lanes, the any-hit at its own tile.
    r8 = ablations.pack_rays(o, d, 1e16, n)
    s8 = ablations.pack_rays(*shadow, n)
    rW = ablations.pack_rays(oW, dW, 1e16, oW.shape[0])
    sW = ablations.pack_rays(*shadow_wide, oW.shape[0])

    def lists_of(r, closest, lanes=rt, build=ablations.stream_lists):
        return build(r, boxes, scale, lanes, 0.01,
                     1e16 if closest else r[:, 6])

    def plain_lists(r, closest, lanes=rt):
        return lists_of(r, closest, lanes, ablations.stream_candidates)
    _check_kernel(records, "stream_lists", lambda: lists_of(s8, False, occ_rt),
                  lambda: plain_lists(s8, False, occ_rt), boxes.shape[0],
                  _compare_lists,
                  lambda out: _list_work(s8, boxes, out, occ_rt, True), n=n,
                  reps=10, plain_reps=1,
                  at_n_rays=lambda: lists_of(sW, False, occ_rt),
                  label=f"stream_lists (any-hit, tiles of {occ_rt})")
    rec = records["stream_lists"][-1]
    grp = ablations.GRP_LANES
    # The build at the closest side's tile and at K15's, each timed (the
    # any-hit's at N_RAYS is ms_at_n_rays; the closest side's there is
    # ms_closest_at_n_rays).
    for key, what, r, closest, lanes in (
            ("ms_closest", f"closest, tiles of {rt}", r8, True, rt),
            ("ms_grp_closest", f"K15 closest, tiles of {grp}", r8, True, grp),
            ("ms_grp_any", f"K15 any-hit, tiles of {grp}", s8, False, grp),
            ("ms_closest_at_n_rays", f"closest, tiles of {rt}", rW, True,
             rt)):
        _, extra = _compare_lists("stream_lists", lists_of(r, closest, lanes),
                                  plain_lists(r, closest, lanes))
        rec[key] = gpu_ms(lambda: lists_of(r, closest, lanes), 10)
        say("kernels", f"stream_lists ({what}): {rec[key]:.4f} ms at "
            f"{r.shape[0]} rays; {extra}")
    _compare_lists("stream_lists", lists_of(sW, False, occ_rt),
                   plain_lists(sW, False, occ_rt))
    for m in N_RAGGED:
        for lanes in (occ_rt, rt, grp):
            for r, closest in ((ablations.pack_rays(
                    o[:m], d[:m], 1e16, ablations._pad_tile(m, lanes)), True),
                    (ablations.pack_rays(
                        *(x[:m] for x in shadow),
                        ablations._pad_tile(m, lanes)), False)):
                _compare_lists(f"stream_lists at {m} rays, tiles of {lanes}",
                               lists_of(r, closest, lanes),
                               plain_lists(r, closest, lanes))
    say("kernels", f"stream_lists at {N_RAGGED} rays, tiles of "
        f"{(occ_rt, rt, grp)}, closest and any-hit: bitwise equal to "
        "stream_candidates")
    # Ties and keys at and beyond T_FAR: the boxes ten times over (every
    # key tied ten ways; above 48 KB of shared memory), and boxes entered
    # beyond T_FAR (1e16) at a tmax of 1e30, after the table and before it.
    slabs = torch.tensor([[1e16, -1e17, -1e17, 3e16, 1e17, 1e17, 0, 0],
                          [2e16, -1e17, -1e17, 4e16, 1e17, 1e17, 0, 0],
                          [-3e16, -1e17, -1e17, -1e16, 1e17, 1e17, 0, 0]],
                         device=boxes.device).repeat(4, 1)
    beyond = 0
    for what, table2, tmx in (
            ("the boxes ten times over", boxes.repeat(10, 1), 1e16),
            ("far boxes after", torch.cat([boxes, slabs]), 1e30),
            ("far boxes before", torch.cat([slabs, boxes]), 1e30)):
        r = ablations.pack_rays(o, d, tmx, n)
        for lanes in (grp, occ_rt, rt):
            args = (r, table2.contiguous(), scale, lanes, 0.01, tmx)
            got = ablations.stream_lists(*args)
            _compare_lists(f"stream_lists, {what}, tiles of {lanes}", got,
                           ablations.stream_candidates(*args))
            beyond += int((got[1] > 1e16).sum())
    if not beyond:
        raise AssertionError("no listed key lay beyond T_FAR")
    say("kernels", f"stream_lists with every box tied ten ways "
        f"({10 * boxes.shape[0]} boxes) and with boxes entered beyond T_FAR "
        f"({beyond} keys above it), tiles of {(grp, occ_rt, rt)}: bitwise "
        "equal to stream_candidates")
    lc, lo, lcW, loW = (lists_of(r8, True), lists_of(s8, False, occ_rt),
                        lists_of(rW, True), lists_of(sW, False, occ_rt))
    say("kernels", f"stream_lists: tiles of {rt} lanes list "
        f"{float(lc[2].float().mean()):.1f} (closest), tiles of {occ_rt} "
        f"{float(lo[2].float().mean()):.1f} (any-hit) of {boxes.shape[0]} "
        f"boxes at {n} rays; the any-hit's lanes a ray "
        f"{ablations.stream_occ_group(n)} at {n} rays, "
        f"{ablations.stream_occ_group(oW.shape[0])} at {oW.shape[0]}")
    run("closest_streamed",
        lambda: ablations.closest_streamed(r8, *table, lc, rt, 0.01),
        lambda: ablations._streamed_plain(r8, *table, lc, rt, 0.01, 1e16,
                                          True, False),
        streamed_work(lc, closest_work),
        lambda: ablations.closest_streamed(rW, *table, lcW, rt, 0.01),
        build=lambda: lists_of(r8, True),
        path=lambda: ablations.closest_stream_path(o, d, *table, 0.01),
        path_work=closest_work)
    run("occluded_streamed",
        lambda: ablations.occluded_streamed(s8, *table, lo, occ_rt, 0.01),
        lambda: ablations._streamed_plain(s8, *table, lo, occ_rt, 0.01, 1e16,
                                          True, True),
        streamed_work(lo, occluded_work, occ_rt),
        lambda: ablations.occluded_streamed(sW, *table, loW, occ_rt, 0.01),
        build=lambda: lists_of(s8, False, occ_rt),
        path=lambda: ablations.occluded_stream_path(*shadow, *table, 0.01),
        path_work=occluded_work)
    # The any-hit at every width it is built for, with the guard on and off.
    for g in clustered.GROUPS:
        for guard in (True, False):
            got = ablations.occluded_streamed(s8, *table, lo, occ_rt, 0.01,
                                              guard, group=g)
            torch.cuda.synchronize()
            if not torch.equal(got, k8_out):
                raise AssertionError(f"occluded_streamed at {g} lanes a ray,"
                                     f" guard {guard}: differs from K8")
    say("kernels", f"occluded_streamed at {clustered.GROUPS} lanes a ray, "
        f"guard on and off: bitwise equal to K8 on {n} rays")
    # The closest hit the same way, and at N_RAYS against K6 and its plain
    # version, guard on and off.
    t0 = time.perf_counter()
    for g in clustered.GROUPS:
        for guard in (True, False):
            got = ablations.closest_streamed(r8, *table, lc, rt, 0.01, 1e16,
                                             guard, group=g)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], t6) and torch.equal(got[1], row6)):
                raise AssertionError(f"closest_streamed at {g} lanes a ray,"
                                     f" guard {guard}: differs from K6")
    for guard in (True, False):
        got = ablations.closest_streamed(rW, *table, lcW, rt, 0.01, 1e16,
                                         guard)
        plain = ablations._streamed_plain(rW, *table, lcW, rt, 0.01, 1e16,
                                          guard, False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, plain)) \
                or not (torch.equal(got[0], t6W) and torch.equal(got[1], row6W)):
            raise AssertionError(f"closest_streamed at {oW.shape[0]} rays, "
                                 f"guard {guard}: differs from its plain "
                                 "version or K6")
    say("kernels", f"closest_streamed at {clustered.GROUPS} lanes a ray, "
        f"guard on and off: bitwise equal to K6 on {n} rays; at "
        f"{oW.shape[0]} rays ({ablations.stream_closest_group(oW.shape[0])} "
        f"lanes a ray), guard on and off, to its plain version and K6 "
        f"({time.perf_counter() - t0:.1f} s)")

    # K13: the schedule built on the card, held against its plain version
    # and timed (at the any-hit's and the closest side's rays, and at
    # N_RAYS); built once, the folded kernels timed alone and held against
    # their plain version on the same schedule (every lane).
    job = ablations.CBIN_JOB_TILE

    def sched(r, build=ablations.cbin_schedule):
        return build(r, boxes, scale, 0.01, job)
    _check_kernel(records, "cbin_schedule", lambda: sched(s8),
                  lambda: sched(s8, ablations._cbin_schedule), boxes.shape[0],
                  _compare_cbin_schedule,
                  lambda out: _cbin_schedule_work(s8, boxes, scale, out), n=n,
                  reps=10, plain_reps=1, at_n_rays=lambda: sched(sW),
                  label=f"cbin_schedule (any-hit, jobs of {job})")
    rec = records["cbin_schedule"][-1]
    for key, r in (("ms_closest", r8), ("ms_closest_at_n_rays", rW)):
        _, extra = _compare_cbin_schedule("cbin_schedule", sched(r),
                                          sched(r, ablations._cbin_schedule))
        rec[key] = gpu_ms(lambda: sched(r), 10)
        say("kernels", f"cbin_schedule (closest): {rec[key]:.4f} ms at "
            f"{r.shape[0]} rays; {extra}")
    _, extra = _compare_cbin_schedule("cbin_schedule", sched(sW),
                                      sched(sW, ablations._cbin_schedule))
    say("kernels", f"cbin_schedule (any-hit) at {sW.shape[0]} rays: {extra}")
    sc, so, scW, soW = (sched(r) for r in (r8, s8, rW, sW))
    for name, sweep, sch, schW, work, r, rw, path in (
            ("closest_cbin", ablations.closest_cbin, sc, scW, closest_work,
             r8, rW, lambda: ablations.closest_cbin_path(o, d, *table, 0.01)),
            ("occluded_cbin", ablations.occluded_cbin, so, soW,
             occluded_work, s8, sW,
             lambda: ablations.occluded_cbin_path(*shadow, *table, 0.01,
                                                  finish=k8_finish))):
        any_hit = name == "occluded_cbin"
        run(name, lambda: sweep(r, rows, sch, cluster, 0.01),
            lambda: ablations._cbin_fold_plain(r, rows, sch, cluster, 0.01,
                                               any_hit),
            lambda out: _cbin_work(r, rows, sch, cluster, any_hit),
            lambda: sweep(rw, rows, schW, cluster, 0.01),
            build=lambda: sched(r), path=path, path_work=work)

    # K14: the pair schedule built on the card, held against its plain
    # version and timed (at the any-hit's and the closest side's rays, and
    # at N_RAYS); built once at the chosen tile, the kernel (with its fused
    # fold) timed alone, its bound from its live pairs, no slab test; the
    # kernels at every tile width against the chosen one.
    k14, tile = ablations.PAIR_K, ablations.BINNED_TILE
    t_k14 = time.perf_counter()

    def pairs_of(r, closest, k=k14, tile=tile,
                 build=ablations.pair_schedule):
        return build(r, boxes, scale, k, 0.01, 1e16 if closest else r[:, 6],
                     tile)

    def schedule_work(r, occluded):
        """The schedule's own work: a slab test of every (ray, box) pair
        and, per ray, one insertion step per pierced box; bytes: the rays
        (and their tmax) and the boxes in, the slot and tile tables,
        next_tn and overflow out."""
        def work(out):
            pierced = int(sum(int(ok.sum()) for _, ok, _ in
                              ablations._ray_box_test(
                                  r, boxes, scale, 0.01,
                                  r[:, 6] if occluded else 1e16, 1024)))
            n_r = r.shape[0]
            return (n_r * boxes.shape[0] * BOX_FLOPS + pierced,
                    n_r * (32 + (4 if occluded else 0)) + boxes.numel() * 4
                    + out.pair_ray.numel() * 4 + out.tile_sid.numel() * 4
                    + n_r * 5)
        return work
    _check_kernel(records, "pair_schedule", lambda: pairs_of(s8, False),
                  lambda: pairs_of(s8, False,
                                   build=ablations._pair_schedule),
                  boxes.shape[0], _compare_schedule,
                  schedule_work(s8, True), n=n, reps=10, plain_reps=2,
                  at_n_rays=lambda: pairs_of(sW, False),
                  label=f"pair_schedule (any-hit, k {k14}, tiles of {tile})")
    rec = records["pair_schedule"][-1]
    for r, closest in ((r8, True), (rW, True), (sW, False)):
        _, extra = _compare_schedule(
            "pair_schedule", pairs_of(r, closest),
            pairs_of(r, closest, build=ablations._pair_schedule))
        say("kernels", f"pair_schedule ({'closest' if closest else 'any-hit'}"
            f", {r.shape[0]} rays): {extra}")
    rec["ms_closest"] = gpu_ms(lambda: pairs_of(r8, True), 10)
    rec["ms_closest_at_n_rays"] = gpu_ms(lambda: pairs_of(rW, True), 10)
    rec["ms_tiles"] = {}
    for t in ablations.BINNED_TILES:
        for k in (k14, 2):
            _compare_schedule("pair_schedule", pairs_of(r8, True, k, t),
                              pairs_of(r8, True, k, t,
                                       build=ablations._pair_schedule))
        rec["ms_tiles"][t] = gpu_ms(lambda: pairs_of(r8, True, tile=t), 10)
    say("kernels", f"pair_schedule: closest side {rec['ms_closest']:.4f} ms "
        f"at {n} rays, {rec['ms_closest_at_n_rays']:.4f} at {N_RAYS}; at "
        f"tiles of {ablations.BINNED_TILES} (k {k14} and 2, each bitwise as "
        f"above) { {t: round(v, 4) for t, v in rec['ms_tiles'].items()} } ms;"
        f" these checks took {time.perf_counter() - t_k14:.1f} s")
    bc, bo, bcW, boW = (pairs_of(r8, True), pairs_of(s8, False),
                        pairs_of(rW, True), pairs_of(sW, False))
    ns = boxes.shape[0]
    say("kernels", f"pair_schedule (k {k14}, tiles of {tile}): "
        f"{int((bc.pair_ray >= 0).sum())} (closest) and "
        f"{int((bo.pair_ray >= 0).sum())} (any-hit) pairs in "
        f"{int((bc.tile_sid < ns).sum())} / {int((bo.tile_sid < ns).sum())} "
        f"live tiles of {bc.tile_sid.shape[0]} at {n} rays; "
        f"{float(bc.overflow.float().mean()):.4f} / "
        f"{float(bo.overflow.float().mean()):.4f} of lanes overflow")
    for name, sch, schW, r, rWide, any_hit, path, work in (
            ("closest_binned", bc, bcW, r8, rW, False,
             lambda: ablations.closest_binned_path(o, d, *table, 0.01,
                                                   nodes=tb.nodes),
             closest_work),
            ("occluded_binned", bo, boW, s8, sW, True,
             lambda: ablations.occluded_binned_path(*shadow, *table, 0.01,
                                                    nodes=tb.nodes),
             occluded_work)):
        sweep = getattr(ablations, name)
        args = (r, rows, sch.pair_ray, sch.tile_sid, cluster, 0.01)
        run(name, lambda: sweep(*args), lambda: _plain(name, args),
            lambda out: _binned_work(r, rows, sch, cluster, any_hit),
            lambda: sweep(rWide, rows, schW.pair_ray, schW.tile_sid, cluster,
                          0.01),
            build=lambda: pairs_of(r, not any_hit), path=path,
            path_work=work)
        want = sweep(*args)
        for t in ablations.BINNED_TILES:
            sch_t = pairs_of(r, not any_hit, tile=t)
            got = sweep(r, rows, sch_t.pair_ray, sch_t.tile_sid, cluster,
                        0.01)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in
                       zip(got if isinstance(got, tuple) else (got,),
                           want if isinstance(want, tuple) else (want,))):
                raise AssertionError(f"{name} at tiles of {t} differs from "
                                     f"tiles of {tile}")
        say("kernels", f"{name} at tiles of {ablations.BINNED_TILES}: "
            f"bitwise equal to tiles of {tile}; K14's checks so far "
            f"{time.perf_counter() - t_k14:.1f} s")

    # K15: the group lists (stream_candidates at 8 lanes) built once; the
    # serial and the bundled body each timed alone.
    lanes = ablations.GRP_LANES
    gc, go, gcW, goW = (lists_of(r8, True, lanes), lists_of(s8, False, lanes),
                        lists_of(rW, True, lanes), lists_of(sW, False, lanes))
    say("kernels", f"group lists: groups of {lanes} lanes list "
        f"{float(gc[2].float().mean()):.1f} (closest) and "
        f"{float(go[2].float().mean()):.1f} (any-hit) of {ns} boxes at {n} "
        f"rays")

    def grp_path(fn, mode, *args):
        with _env(TPT_GRP=mode):
            return fn(*args)
    for bundled in (False, True):
        mode = "2" if bundled else "1"
        body = "bundled" if bundled else "serial"
        run("closest_grp",
            lambda: ablations.closest_grp(r8, *table, gc, 0.01,
                                          bundled=bundled),
            lambda: _plain("closest_grp", (r8, *table, gc, 0.01, 1e16,
                                           bundled)),
            streamed_work(gc, closest_work, lanes),
            lambda: ablations.closest_grp(rW, *table, gcW, 0.01,
                                          bundled=bundled),
            build=lambda: lists_of(r8, True, lanes),
            path=lambda: grp_path(ablations.closest_grp_path, mode, o, d,
                                  *table, 0.01),
            path_work=closest_work, label=f"closest_grp ({body})")
        run("occluded_grp",
            lambda: ablations.occluded_grp(s8, *table, go, 0.01,
                                           bundled=bundled),
            lambda: _plain("occluded_grp", (s8, *table, go, 0.01, bundled)),
            streamed_work(go, occluded_work, lanes),
            lambda: ablations.occluded_grp(sW, *table, goW, 0.01,
                                           bundled=bundled),
            build=lambda: lists_of(s8, False, lanes),
            path=lambda: grp_path(ablations.occluded_grp_path, mode,
                                  *shadow, *table, 0.01),
            path_work=occluded_work, label=f"occluded_grp ({body})")
    # K15 at every width, serial and bundled, against its plain version
    # and K6 / K8, at n rays (one in PARK_EVERY parked) and at N_RAYS.
    t_k = time.perf_counter()
    k8W = clustered.occluded_clustered(*shadow_wide, *table, 0.01, tb.nodes)
    for what, rc, rs, l_c, l_o, want_c, want_o in (
            (f"{n} rays", r8, s8, gc, go, (t6, row6), k8_out),
            (f"{oW.shape[0]} rays", rW, sW, gcW, goW, (t6W, row6W), k8W)):
        plain_c = ablations._grp_plain(rc, *table, l_c, 0.01, 1e16, False)
        plain_o = ablations._grp_plain(rs, *table, l_o, 0.01, 1e16, True)
        for g in clustered.GROUPS:
            for bundled in (False, True):
                got_c = ablations.closest_grp(rc, *table, l_c, 0.01,
                                              bundled=bundled, group=g)
                got_o = ablations.occluded_grp(rs, *table, l_o, 0.01,
                                               bundled=bundled, group=g)
                torch.cuda.synchronize()
                if not (all(torch.equal(a, b) for a, b in
                            zip(got_c, plain_c))
                        and all(torch.equal(a, b) for a, b in
                                zip(got_c, want_c))
                        and torch.equal(got_o, plain_o)
                        and torch.equal(got_o, want_o)):
                    raise AssertionError(
                        f"K15 at {what}, {g} lanes a ray, bundled {bundled}:"
                        " differs from its plain version or K6 / K8")
    say("kernels", f"closest_grp / occluded_grp at {clustered.GROUPS} lanes "
        f"a ray, serial and bundled: bitwise equal to their plain versions "
        f"and K6 / K8 at {n} and {oW.shape[0]} rays "
        f"({ablations.grp_group(n)} / {ablations.grp_occ_group(n)} lanes a "
        f"ray shipped at {n}; {time.perf_counter() - t_k:.1f} s)")

    # The whole paths against K6 / K8 under every knob, at n and at ragged
    # ray counts.
    def with_caps(caps, fn):
        """fn() under (CBIN_GROUP, CBIN_PAIR_MULT, CBIN_K_OUT, CBIN_LVL,
        TPT_CBIN_EXACT) = caps."""
        names = ("CBIN_GROUP", "CBIN_PAIR_MULT", "CBIN_K_OUT", "CBIN_LVL")
        saved = [getattr(ablations, k) for k in names]
        for k, v in zip(names, caps):
            setattr(ablations, k, v)
        try:
            with _env(TPT_CBIN_EXACT=caps[4]):
                return fn()
        finally:
            for k, v in zip(names, saved):
                setattr(ablations, k, v)

    # K13's cap settings: the default (two-level lists at g = 1), groups of
    # 8 (the exact union), starved caps, the flat interval lists
    # (TPT_CBIN_LVL=1), the two-level ones at g = 8 (TPT_CBIN_LVL=2) and
    # the flat interval test at g = 8 (TPT_CBIN_EXACT=0). At each, the
    # schedule on the card against its plain version, and the folded
    # kernels against the reference's reduce over cbin_pairs' per-pair
    # results on the lanes that are not incomplete.
    starved = (1, 1, 2, 0, "1")
    cbin_caps = ((1, 12, 32, 0, "1"), (8, 12, 32, 0, "1"), starved,
                 (1, 12, 32, 1, "1"), (8, 12, 32, 2, "1"),
                 (8, 12, 32, 1, "0"))
    t0 = time.perf_counter()
    for caps in cbin_caps:
        for r, any_hit in ((r8, False), (s8, True)):
            def layout(r=r, any_hit=any_hit):
                got = sched(r)
                _, extra = _compare_cbin_schedule(
                    f"cbin_schedule under {caps}", got,
                    sched(r, ablations._cbin_schedule))
                fold = (ablations.occluded_cbin if any_hit
                        else ablations.closest_cbin)(r, rows, got, cluster,
                                                     0.01)
                pr, jt, tgt, inc, (ng, g, k) = ablations.cbin_pairs(
                    r, boxes, scale, 0.01, job)
                res = ablations._cbin_sweep_plain(pr, rows, jt, cluster, job,
                                                  0.01, any_hit)
                ref = ((ablations._cbin_reduce_occ(res, tgt, n, ng, g, k),)
                       if any_hit else
                       ablations._cbin_reduce(*res, tgt, n, ng, g, k))
                fold = (fold,) if any_hit else fold
                torch.cuda.synchronize()
                if not all(torch.equal(a[~inc], b[~inc])
                           for a, b in zip(fold, ref)):
                    raise AssertionError(
                        f"K13 under {caps}: the folded kernel differs from "
                        "the reference's reduce on a complete lane")
                return extra
            extra = with_caps(caps, layout)
            say("kernels", f"K13 {'any-hit' if any_hit else 'closest'} under"
                f" group / pair mult / k / lvl / exact {caps}: schedule "
                f"{extra}; the fold bitwise equal to _cbin_reduce"
                f"{'_occ' if any_hit else ''} over cbin_pairs on every "
                "complete lane")
    say("kernels", f"K13's schedule and fold under {len(cbin_caps)} cap "
        f"settings: {time.perf_counter() - t0:.1f} s")
    ids6 = torch.where(t6 < 1e15, rows[row6.long(), 15], 0.0).to(torch.int32)
    for m in (n,) + N_RAGGED:
        oo, dd = o[:m].contiguous(), d[:m].contiguous()
        sh = tuple(x[:m].contiguous() for x in shadow)
        want_c, want_o = (t6[:m], row6[:m]), (k8_out[:m],)
        want_h = (t6[:m], ids6[:m])

        def binned_c(k):
            h = ablations.closest_binned_path(oo, dd, *table, 0.01, k=k,
                                              nodes=tb.nodes)
            return h.t, h.tri

        def binned_o(k):
            return (ablations.occluded_binned_path(*sh, *table, 0.01, k=k,
                                                   nodes=tb.nodes),)

        def stream_c():
            return ablations.closest_stream_path(oo, dd, *table, 0.01)

        def stream_o():
            return (ablations.occluded_stream_path(*sh, *table, 0.01),)

        def cbin_c():
            return ablations.closest_cbin_path(oo, dd, *table, 0.01)

        def cbin_o():
            return (ablations.occluded_cbin_path(*sh, *table, 0.01,
                                                 finish=k8_finish),)
        checks = [(f"K11 {w}", lambda p=p: k11(oo, dd, p[:m].contiguous()),
                   want_c) for w, p in preds.items()]
        for guard in ("1", "0"):
            for what, fn, want in (("closest", stream_c, want_c),
                                   ("any-hit", stream_o, want_o)):
                def guarded(fn=fn, guard=guard):
                    with _env(TPT_STREAM_GUARD=guard):
                        return fn()
                checks.append((f"K12 {what}, guard {guard}", guarded, want))
        for caps in cbin_caps:
            for what, fn, want in (("closest", cbin_c, want_c),
                                   ("any-hit", cbin_o, want_o)):
                checks.append((f"K13 {what}, group / pair mult / k / lvl / "
                               f"exact {caps}",
                               lambda fn=fn, caps=caps: with_caps(caps, fn),
                               want))
        for k in (k14, 2):
            checks += [(f"K14 closest, k {k}", lambda k=k: binned_c(k),
                        want_h),
                       (f"K14 any-hit, k {k}", lambda k=k: binned_o(k),
                        want_o)]
        for mode in ("1", "2"):
            checks += [
                (f"K15 closest, TPT_GRP={mode}",
                 lambda mode=mode: grp_path(ablations.closest_grp_path, mode,
                                            oo, dd, *table, 0.01), want_c),
                (f"K15 any-hit, TPT_GRP={mode}",
                 lambda mode=mode: (grp_path(ablations.occluded_grp_path,
                                             mode, *sh, *table, 0.01),),
                 want_o)]
        for what, fn, want in checks:
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{what} at {m} rays differs from "
                                     "K6 / K8")
        say("kernels", f"K11 ({len(preds)} predictions), K12 (guard on and "
            f"off), K13 ({len(cbin_caps)} cap settings, one starved), K14 "
            f"(k {k14} and 2) "
            f"and K15 (serial, bundled), closest and any-hit paths: "
            f"{len(checks)} results bitwise equal to K6 / K8 on {m} rays")
    share = float(with_caps(starved, lambda: sched(r8)).incomplete.float()
                  .mean())
    say("kernels", f"K13 with starved caps (pair mult 1, k 2): "
        f"{share:.4f} of lanes go through the completion pass")
    if share < 0.5:
        raise AssertionError("the starved caps must leave most lanes to the "
                             "completion pass")
    # K14 at k = 2: the lanes its completion pass carries (overflow, the
    # fold's hit not nearer than the next entry).
    sch2 = pairs_of(r8, True, 2)
    t2, _ = ablations.closest_binned(r8, rows, sch2.pair_ray, sch2.tile_sid,
                                     cluster, 0.01)
    carried = int((sch2.overflow & (t2 >= sch2.next_tn)).sum())
    so2 = pairs_of(s8, False, 2)
    occ2 = ablations.occluded_binned(s8, rows, so2.pair_ray, so2.tile_sid,
                                     cluster, 0.01)
    carried_o = int((so2.overflow & ~occ2).sum())
    say("kernels", f"K14 at k 2: the completion pass carries {carried} "
        f"(closest) and {carried_o} (any-hit) of {n} lanes")
    if carried == 0 or carried_o == 0:
        raise AssertionError("K14 at k = 2 must send live lanes through its "
                             "completion passes")


def _tiled_table(tb, copies: int):
    """The big mesh's clustered table ``copies`` times over, copy j moved
    along x by j times 1.25 of the mesh's width (alternately right and
    left of it), built on the card: each row's plane and edge functions
    rewritten for the move, each copy's triangle ids after the last's.
    Returns (rows, boxes, nodes, scale)."""
    import torch
    from tpu_pt_torch.intersect import clustered
    rows, boxes = tb.rows, tb.boxes
    real = boxes[:, 0] < 1e30
    width = float((boxes[real, 3] - boxes[real, 0]).max())
    n_ids = int(rows[:, 15].max()) + 1
    all_rows, all_boxes = [], []
    for j in range(copies):
        dx = 1.25 * width * ((j + 1) // 2) * (1 if j % 2 else -1)
        r = rows.clone()
        r[:, 3] = rows[:, 3] + rows[:, 0] * dx       # n . (p + dx) = d0'
        r[:, 7] = rows[:, 7] - rows[:, 4] * dx       # wu . p + cu
        r[:, 11] = rows[:, 11] - rows[:, 8] * dx     # wv . p + cv
        r[:, 15] = torch.where(rows[:, 12] > 0.5, rows[:, 15] + j * n_ids,
                               rows[:, 15])
        b = boxes.clone()
        b[:, 0] = torch.where(real, boxes[:, 0] + dx, boxes[:, 0])
        b[:, 3] = torch.where(real, boxes[:, 3] + dx, boxes[:, 3])
        all_rows.append(r)
        all_boxes.append(b)
    rows2 = torch.cat(all_rows).contiguous()
    boxes2 = torch.cat(all_boxes).contiguous()
    return rows2, boxes2, clustered.cluster_tree(boxes2), \
        clustered.box_scale(boxes2)


def phase_list_caps(device, smi, big, records):
    """The tile-list build past the shared-memory build's caps
    (``ablations.list_route``: more than LIST_MAX_TILE rays a tile or
    LIST_MAX_BOXES boxes): bitwise against ``stream_candidates`` at tiles
    of LIST_CAP_TILE on the big mesh's 784 boxes and on a table of more
    than 8,192 clusters (the big mesh LIST_CAP_COPIES times over, built on
    the card: 8,624 clusters, 1.1M rows), at the two sides of the box cap
    (8,192 and 8,193 boxes of that table), on N_PLAIN_BIG rays with one in
    PARK_EVERY parked (camera and bounce rays of that table, shadow rays
    to the light); the build timed at the any-hit's tile. Then, counters
    zeroed before and read after, one closest and one any-hit call of the
    paths ``TPT_STREAM=1`` takes (the lists, then K12) on that table,
    bitwise against K6 / K8 on the same rays. Returns the launches."""
    import torch
    from tpu_pt_torch.intersect import ablations, clustered
    t0 = time.perf_counter()
    tb = clustered.prepare(big)
    rows, boxes, nodes, scale = _tiled_table(tb, LIST_CAP_COPIES)
    n_c = boxes.shape[0]
    if n_c <= ablations.LIST_MAX_BOXES:
        raise AssertionError(f"{n_c} clusters do not pass the box cap")
    table = (rows, boxes, scale, 0.01)

    def k6(o, d):
        return clustered.closest_clustered(o, d, *table, nodes=nodes)
    o, d, shadow = _phase3_rays(big, device, 5, rows, k6, N_PLAIN_BIG)
    (o, d), shadow = _park((o, d), shadow, PARK_EVERY)
    occ_rt = ablations.STREAM_OCC_TILE
    r8 = ablations.pack_rays(o, d, 1e16, o.shape[0])
    s8 = ablations.pack_rays(*shadow, o.shape[0])
    checked = []
    # K15's tiles (the small-tile route) on the table past the box cap, on
    # the first SMALL_CAP_RAYS rays.
    m = SMALL_CAP_RAYS
    for r, closest in ((r8[:m], True), (s8[:m], False)):
        args = (r, boxes, scale, ablations.GRP_LANES, 0.01,
                1e16 if closest else r[:, 6])
        _, extra = _compare_lists(
            f"stream_lists ({n_c} boxes, tiles of {ablations.GRP_LANES})",
            ablations.stream_lists(*args), ablations.stream_candidates(*args))
    checked.append(f"{n_c} boxes at tiles of {ablations.GRP_LANES} "
                   f"({ablations.list_route(n_c, ablations.GRP_LANES)}, {m} "
                   f"rays): {extra}")
    for what, bx in (("784 boxes", tb.boxes), (f"{n_c} boxes", boxes),
                     ("8,192 boxes", boxes[:8192].contiguous()),
                     ("8,193 boxes", boxes[:8193].contiguous())):
        for lanes in sorted({occ_rt, ablations.STREAM_CLOSEST_TILE,
                             LIST_CAP_TILE}):
            route = ablations.list_route(bx.shape[0], lanes)
            if route == "shared" and bx.shape[0] != 8192:
                continue
            for r, closest in ((r8, True), (s8, False)):
                args = (r, bx, scale, lanes, 0.01, 1e16 if closest
                        else r[:, 6])
                _, extra = _compare_lists(
                    f"stream_lists ({what}, tiles of {lanes})",
                    ablations.stream_lists(*args),
                    ablations.stream_candidates(*args))
            checked.append(f"{what} at tiles of {lanes} ({route}): {extra}")
    for line in checked:
        say("caps", f"stream_lists, {line}; closest and any-hit bitwise "
            "equal to stream_candidates")
    rec = records["stream_lists"][0]
    args = (s8, boxes, scale, occ_rt, 0.01, s8[:, 6])
    rec["ms_global"] = gpu_ms(lambda: ablations.stream_lists(*args), 5)
    rec["plain_ms_global"] = gpu_ms(
        lambda: ablations.stream_candidates(*args), 1)
    say("caps", f"stream_lists past the box cap ({n_c} boxes, tiles of "
        f"{occ_rt}, {s8.shape[0]} rays): {rec['ms_global']:.4f} ms, "
        f"stream_candidates {rec['plain_ms_global']:.4f} ms")
    want_t, want_row = k6(o, d)
    want_occ = clustered.occluded_clustered(*shadow, *table, nodes=nodes)
    # K12's closest hit at tiles of LIST_CAP_TILE on that table, guard on
    # and off, against K6 and its plain version (the lists past both caps).
    lists = ablations.stream_lists(r8, boxes, scale, LIST_CAP_TILE, 0.01,
                                   1e16)
    for guard in (True, False):
        got = ablations.closest_streamed(r8, rows, boxes, scale, lists,
                                         LIST_CAP_TILE, 0.01, 1e16, guard)
        plain = ablations._streamed_plain(r8, rows, boxes, scale, lists,
                                          LIST_CAP_TILE, 0.01, 1e16, guard,
                                          False)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(got, plain))
                and torch.equal(got[0], want_t)
                and torch.equal(got[1], want_row)):
            raise AssertionError(f"closest_streamed on {n_c} clusters at "
                                 f"tiles of {LIST_CAP_TILE}, guard {guard}:"
                                 " differs from its plain version or K6")
    say("caps", f"closest_streamed on {n_c} clusters at tiles of "
        f"{LIST_CAP_TILE} (lists past both caps), guard on and off: bitwise "
        "equal to its plain version and K6")
    _zero_counters()
    got_t, got_row = ablations.closest_stream_path(o, d, *table)
    got_occ = ablations.occluded_stream_path(*shadow, *table)
    torch.cuda.synchronize()
    counts = _read_counters()
    if not (torch.equal(got_t, want_t) and torch.equal(got_row, want_row)
            and torch.equal(got_occ, want_occ)):
        raise AssertionError(f"TPT_STREAM=1 paths on {n_c} clusters differ "
                             "from K6 / K8")
    for k, n in (("stream_lists", 2), ("closest_streamed", 1),
                 ("occluded_streamed", 1)):
        if counts[k] != n:
            raise AssertionError(f"caps: {k} launched {counts[k]} times, "
                                 f"not {n}")
    say("caps", f"TPT_STREAM=1 closest and any-hit paths on {n_c} clusters "
        f"({rows.shape[0]} rows, {rows.numel() * 4 / 1e6:.1f} MB) at "
        f"{o.shape[0]} rays: bitwise equal to K6 / K8 "
        f"({int((want_t < 1e15).sum())} hits, {int(want_occ.sum())} "
        f"blocked); launches { {k: n for k, n in counts.items() if n} }; "
        f"the phase took {time.perf_counter() - t0:.1f} s; {smi}")
    return counts


@functools.cache
def _tool(name: str):
    """tools/<name>.py, loaded by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def phase_incoherent(device, smi, big):
    """tools/bench_incoherent_torch.py's rays on the big mesh through
    every scheduler's entry point: results equal to the default path's
    (the tool raises otherwise), device times in interleaved pairs.
    Returns the launches per kernel."""
    _zero_counters()
    out = _tool("bench_incoherent_torch").run(big, INCOHERENT["n"], INCOHERENT["reps"],
                                 True, device, smi=smi)
    counts = _read_counters()
    for p in out:
        parts = ""
        if "build_ms" in p:
            parts = (f" (schedule build {p['build_ms']:.4f} ms, kernel alone "
                     f"{p['kernel_ms']:.4f} ms; "
                     + ", ".join(f"{k} {p[k]}" for k in (
                         "listed_boxes_per_tile", "boxes", "jobs", "job_cap",
                         "incomplete_share", "pairs", "tiles", "tile_cap",
                         "overflow_share", "listed_boxes_per_group")
                         if k in p) + ")")
        say("incoherent", f"{p['metric']}: {p['ms']:.4f} ms "
            f"{[round(x, 4) for x in p['ms_runs']]}, the default path beside "
            f"it {[round(x, 4) for x in p['default_ms_runs']]} ms, "
            f"{p['value']:.3f} Mrays/s{parts}; equal to the default path; "
            f"{p['device']}")
    for k in INCOHERENT_WRAPPERS:
        if counts[k] <= 0:
            raise AssertionError(f"incoherent: {k} never launched")
    # The list build on the same rays, at each of its three tiles, against
    # its plain version (after the counters were read: not the paths'
    # launches).
    from tpu_pt_torch.intersect import ablations, clustered
    tb = clustered.prepare(big)
    o, d, tmax = _tool("bench_incoherent_torch").make_rays(
        big, INCOHERENT["n"], device)
    for lanes, closest in ((ablations.STREAM_OCC_TILE, False),
                           (ablations.STREAM_CLOSEST_TILE, True),
                           (ablations.GRP_LANES, True),
                           (ablations.GRP_LANES, False)):
        r8 = ablations.pack_rays(o, d, 1e16 if closest else tmax,
                                 ablations._pad_tile(o.shape[0], lanes))
        args = (r8, tb.boxes, tb.scale, lanes, 0.01,
                1e16 if closest else r8[:, 6])
        _, extra = _compare_lists("stream_lists", ablations.stream_lists(*args),
                                  ablations.stream_candidates(*args))
        say("incoherent", f"stream_lists ({'closest' if closest else 'any-hit'}"
            f", tiles of {lanes}) on {o.shape[0]} rays: {extra}")
    _incoherent_widths(tb, o, d, tmax)
    return counts


def _incoherent_widths(tb, o, d, tmax):
    """K11 and K15 at every width on the incoherent rays: K11 (the unknown
    and a cycled prediction) against K6 and, at the shipped width, its
    plain version; K15 (serial and bundled)
    against its plain version and K6 / K8. Closest rays unbounded, shadow
    rays at the tool's tmax."""
    import torch
    from tpu_pt_torch.intersect import ablations, clustered
    t0 = time.perf_counter()
    table = (tb.rows, tb.boxes, tb.scale)
    n = o.shape[0]
    want_c = clustered.closest_clustered(o, d, *table, 0.01, nodes=tb.nodes)
    want_o = clustered.occluded_clustered(o, d, tmax, *table, 0.01, tb.nodes)
    srows = clustered._clustered_slab_rows(tb.rows.shape[0])
    s_count = -(-tb.rows.shape[0] // srows)
    preds = (torch.full((n,), clustered.SLAB_UNKNOWN, dtype=torch.int32,
                        device=o.device),
             (torch.arange(n, device=o.device) % s_count).to(torch.int32))
    plain = ablations._closest_rotated_plain(o, d, tb.rows, preds[0], srows,
                                             0.01)
    t_plain = time.perf_counter() - t0
    for pred in preds:
        for g in clustered.GROUPS:
            got = ablations.closest_rotated(o, d, *table, pred, srows, 0.01,
                                            group=g)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want_c)):
                raise AssertionError(f"incoherent: closest_rotated at {g} "
                                     "lanes a ray differs from K6")
    got = ablations.closest_rotated(o, d, *table, preds[0], srows, 0.01)
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError("incoherent: closest_rotated differs from its "
                             "plain version")
    n_pad = ablations._pad_tile(n, ablations.GRP_LANES)
    rc = ablations.pack_rays(o, d, 1e16, n_pad)
    rs = ablations.pack_rays(o, d, tmax, n_pad)
    lc = ablations.stream_lists(rc, *table[1:], ablations.GRP_LANES, 0.01,
                                1e16)
    lo = ablations.stream_lists(rs, *table[1:], ablations.GRP_LANES, 0.01,
                                rs[:, 6])
    plain_c = ablations._grp_plain(rc, *table, lc, 0.01, 1e16, False)
    plain_o = ablations._grp_plain(rs, *table, lo, 0.01, 1e16, True)
    for g in clustered.GROUPS:
        for bundled in (False, True):
            got_c = ablations.closest_grp(rc, *table, lc, 0.01,
                                          bundled=bundled, group=g)
            got_o = ablations.occluded_grp(rs, *table, lo, 0.01,
                                           bundled=bundled, group=g)
            torch.cuda.synchronize()
            if not (all(torch.equal(a, b) for a, b in zip(got_c, plain_c))
                    and all(torch.equal(a[:n], b) for a, b in
                            zip(got_c, want_c))
                    and torch.equal(got_o, plain_o)
                    and torch.equal(got_o[:n], want_o)):
                raise AssertionError(f"incoherent: K15 at {g} lanes a ray, "
                                     f"bundled {bundled}: differs from its "
                                     "plain version or K6 / K8")
    say("incoherent", f"closest_rotated at {clustered.GROUPS} lanes a ray, "
        f"two predictions: bitwise equal to K6 (and its plain "
        f"version, {t_plain:.1f} s, at the shipped width); closest_grp / "
        f"occluded_grp at every width, serial and bundled: bitwise equal to "
        f"their plain versions and K6 / K8 on {n} rays "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_bf16(device, smi, records):
    """K16: tools/microbench_bf16_torch.py's chains on the card, each
    against its plain PyTorch chain on the same [2,048, 1,024] inputs (f32
    bit for bit; bf16 within one bf16 ulp, the differing elements
    counted), kernel and plain timed; then the tool's bench (200 chained
    calls of each) with the launch counters zeroed just before and read
    just after. Returns the launches per kernel."""
    import torch
    mb = _tool("microbench_bf16_torch")
    rates = mb.op_rates()
    rows, cols = mb.shape()
    for name, dtype in (("chain_f32", torch.float32),
                        ("chain_bf16", torch.bfloat16)):
        a, b = mb.make_inputs(dtype, device)
        fn = getattr(mb, name)
        out_k, out_p = fn(a, b), mb.plain_chain(a, b)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out_k.float()).all()):
            raise AssertionError(f"{name}: non-finite results")
        err = float((out_k.float() - out_p.float()).abs().max())
        if dtype == torch.float32:
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{name}: kernel and plain differ on "
                                     f"{int((out_k != out_p).sum())} values")
            note = "bitwise equal"
        else:
            same_sign = bool(((out_k.float() > 0) == (out_p.float() > 0)).all())
            ulps = (out_k.view(torch.int16).int()
                    - out_p.view(torch.int16).int()).abs()
            if not same_sign or int(ulps.max()) > 1:
                raise AssertionError(f"{name}: more than one bf16 ulp from "
                                     f"the plain chain (max {int(ulps.max())})")
            note = (f"{int((ulps > 0).sum())} of {ulps.numel()} elements one "
                    f"bf16 ulp apart, the rest bitwise equal")
        ms = gpu_ms(lambda: fn(a, b), 20)
        plain_ms = gpu_ms(lambda: mb.plain_chain(a, b), 2)
        key = "f32" if dtype == torch.float32 else "bf16"
        bound_ms = mb.operations() / rates[key] * 1e3
        records.setdefault(name, []).append(dict(
            rows=rows, rays=rows * cols, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by="operations",
            flops=mb.operations(), bytes=3 * rows * cols * a.element_size()))
        say("bf16", f"{name} [{rows}, {cols}] x {mb.STEPS} steps x "
            f"{mb.OPS_PER_STEP} ops: {note}, max|err| {err}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({rates['sms']} SMs x {mb.F32_LANES} f32 lanes"
            f"{' x 2 (packed)' if key == 'bf16' else ''} x "
            f"{rates['max_sm_mhz']:.0f} MHz, the maximum SM clock)")
    mb.LAUNCHES.update(dict.fromkeys(mb.LAUNCHES, 0))
    out = mb.run(smi)
    counts = dict(mb.LAUNCHES)
    for p in out:
        name = "chain_" + p["dtype"]
        records[name][0]["bench_ms"] = p["ms_per_call"]
        say("bf16", f"{p['metric']}: {p['ms_per_call']:.4f} ms per call over "
            f"200 chained calls, {p['tops']:.3f} Tops/s against "
            f"{p['bound_tops']:.3f} ({p['ms_per_call'] / p['bound_ms']:.3f}x "
            f"the bound)"
            + (f"; bf16 / f32 rate {p['bf16_over_f32']:.3f}"
               if "bf16_over_f32" in p else "") + f"; {p['device']}")
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"bf16: {k} never launched")
    return counts


def _check_dense_bodies(records, device, mixed, tm, sphere, ts):
    """K2's and K1's dense bodies on the tables their paths hand them, each
    bitwise against its plain version and timed, at N_RAYS and at
    N_SPHERE_RAYS rays with one lane in PARK_EVERY parked: K2 over the
    mixed box's 24-row occluder subset (every shadow ray of the flagship
    frames), ``cornell_box.obj``'s subset and a DENSE_SUBSET_ROWS-row
    subset with no kd copy (the sphere box's first rows, with its shadow
    rays: the largest table a clustered scene hands K2, eight tiles); K1
    over ``cornell_box.obj``'s 32 rows (its own path) and the mixed box's
    432 (the walk's yardstick). K2 sweeps its table's row split through
    the group queue at N_RAYS (``tpt_occluded_split``: from
    dense.OCC_SPLIT_MIN_RAYS) and every row at N_SPHERE_RAYS
    (``tpt_occluded``): both kernels are held, and the split's calls carry
    the culled sweep's own work beside the dense bound
    (``culled_bound_ms``). Then K3's and K4's dense bodies on
    ``cornell_box.obj``, and the edges of the sweeps: shadow rays whose
    tmax is bit for bit the t of their nearest blocking row (and the next
    float above it), rays aimed at shared edges, and tables with zero rows
    padding them to a multiple of 8 (a last iteration of fewer rows, too),
    K2's at both counts; and the split's own edges (``_check_split_edges``).
    The first record of each kernel (its own path at N_RAYS) carries every
    table's time (``ms_tables``)."""
    import numpy as np
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    t0 = time.perf_counter()
    cornell = tp.load_scene(str(ASSETS / "cornell_box.obj"), device=device)
    tc = dense.prepare(cornell)
    if tc.kd is not None or tc.occ_kd is not None or tm.occ_kd is not None:
        raise AssertionError("cornell_box.obj's table and subset and the "
                             "mixed box's subset must have no kd copy")
    sub = ts.occ_rows[:DENSE_SUBSET_ROWS].contiguous()
    first = {}
    device_ms = _tool("dense_ab_torch").device_ms

    def timed(name, what, kernel, plain, table, work, n, culled=None):
        """_check_kernel, then the kernel's device time (device_ms: these
        kernels are shorter than a launch, so gpu_ms times the host; its
        time stays as events_ms); every table's time on the first record
        of ``name``; ``culled()``, when given, the culled sweep's own
        work beside the bound."""
        _check_kernel(records, name, kernel, plain, table.shape[0],
                      _compare_exact, work, n=n, plain_reps=1,
                      label=f"{name} on {what}")
        rec = records[name][-1]
        rec["events_ms"], rec["ms"] = rec["ms"], device_ms(kernel, 20)
        first.setdefault(name, rec).setdefault("ms_tables", {})[
            f"{what}, {table.shape[0]} rows, {n} rays"] = rec["ms"]
        extra = ""
        if culled is not None:
            rec["culled_bound_ms"] = _bound(*culled())["bound_ms"]
            extra = (f" (the culled sweep's own work: "
                     f"{rec['culled_bound_ms']:.4f})")
        say("kernels", f"{name} on {what}, {n} rays: {rec['ms']:.4f} ms a "
            f"call on the card, back to back (events around the host's "
            f"calls: {rec['events_ms']:.4f}); bound {rec['bound_ms']:.4f}"
            f"{extra}")

    def parked(scene, tables, seed, n):
        rows = tables.rows
        o, d, shadow = _phase3_rays(
            scene, device, seed, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), n)
        return _park((o, d), shadow, PARK_EVERY)

    def exact(name, what, kernel, plain, rows, n):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        _compare_exact(f"{name} on {what}", out_k, out_p)
        records[name].append(dict(rows=rows, rays=n, max_abs_err=0.0))
        return out_p

    for n in (N_RAYS, N_SPHERE_RAYS):
        (om, dm), shm = parked(mixed, tm, 1, n)
        (oc, dc), shc = parked(cornell, tc, 5, n)
        _, shs = parked(sphere, ts, 2, n)
        for what, table, sh in (("the mixed box's subset", tm.occ_rows, shm),
                                ("cornell_box.obj's subset", tc.occ_rows,
                                 shc),
                                (f"a {DENSE_SUBSET_ROWS}-row subset", sub,
                                 shs)):
            timed("occluded", what,
                  lambda sh=sh, table=table: dense.occluded(*sh, table, 0.01),
                  lambda sh=sh, table=table: dense._occluded_plain(
                      *sh, table, 0.01), table,
                  lambda out, sh=sh, table=table: _dense_occluded_work(
                      *sh, table), n,
                  culled=(lambda sh=sh, table=table: _split_occluded_work(
                      *sh, table)) if n >= dense.OCC_SPLIT_MIN_RAYS else None)
        for what, table, o, d in (("cornell_box.obj", tc.rows, oc, dc),
                                  ("the mixed box", tm.rows, om, dm)):
            timed("closest_lean", what,
                  lambda o=o, d=d, table=table: dense.closest_lean(
                      o, d, table, 0.01),
                  lambda o=o, d=d, table=table: dense._closest_plain(
                      o, d, table, 0.01), table,
                  lambda out, o=o, table=table: _dense_work(o, table, 8), n)
        # K3's and K4's dense bodies on their own table (their records
        # come from the later phases).
        out_k = dense.closest_full(oc, dc, tc.rows, 0.01, 600.0, True)
        out_p = dense._closest_plain(oc, dc, tc.rows, 0.01, 600.0, True, True)
        torch.cuda.synchronize()
        _compare_exact("closest_full on cornell_box.obj", out_k, out_p)
        lz1, lz2 = _light_samples(n, 11, device)
        light = dense.light_vector(cornell)
        out_k = dense.closest_nee_lean(oc, dc, lz1, lz2, tc.rows, tc.occ_rows,
                                       light, 0.01)
        out_p = dense._closest_nee_plain(oc, dc, lz1, lz2, tc.rows,
                                         tc.occ_rows, light, 0.01)
        torch.cuda.synchronize()
        _compare_fused("closest_nee_lean on cornell_box.obj", out_k, out_p)
        say("kernels", f"closest_full and closest_nee_lean (K3's, K4's dense "
            f"bodies) on cornell_box.obj's {tc.rows.shape[0]} rows, {n} rays: "
            "bitwise equal to the plain versions")

    # The edges of the sweeps. tmax at the t of each shadow ray's nearest
    # blocking row (the plain version's t, bit for bit): that row must not
    # block, while one float above it, it must. K2 at both counts: its
    # split's kernel and every row's.
    if not N_SPHERE_RAYS < dense.OCC_SPLIT_MIN_RAYS <= N_RAYS:
        raise AssertionError("K2's two kernels need N_SPHERE_RAYS below "
                             "dense.OCC_SPLIT_MIN_RAYS and N_RAYS above")
    (oc, dc), _ = parked(cornell, tc, 7, N_SPHERE_RAYS)
    shadows = {}
    for n in (N_RAYS, N_SPHERE_RAYS):
        shc = parked(cornell, tc, 7, n)[1]
        shm = parked(mixed, tm, 8, n)[1]
        shadows[n] = shm
        for what, table, (so, sd, st) in (
                ("cornell_box.obj's subset", tc.occ_rows, shc),
                ("the mixed box's subset", tm.occ_rows, shm)):
            t_all, _, _ = dense._pe_block(so, sd, table, 0.01)
            t_all = torch.where(table[None, :, 13] < 0.5, t_all, 1e16)
            near = t_all.min(1).values
            hit = near < 1e15
            at = torch.where(hit, near, st).contiguous()
            above = torch.where(hit, torch.nextafter(near, torch.full_like(
                near, float("inf"))), st).contiguous()
            flags = [exact("occluded", f"{what}, tmax {side}",
                           lambda tmax=tmax: dense.occluded(so, sd, tmax,
                                                            table, 0.01),
                           lambda tmax=tmax: dense._occluded_plain(
                               so, sd, tmax, table, 0.01),
                           table.shape[0], n)
                     for side, tmax in (("at t", at), ("above t", above))]
            flips = int((flags[1] & ~flags[0] & hit).sum())
            if flips != int(hit.sum()) or flips < n // 100:
                raise AssertionError(f"K2 on {what}: tmax one float above "
                                     f"the nearest blocking t turned "
                                     f"{flips} of {int(hit.sum())} rays "
                                     "blocked")
            say("kernels", f"occluded (K2's dense body) on {what}, {n} rays:"
                f" tmax at the nearest blocking row's t and one float above "
                f"it, {int(hit.sum())} rays with a blocking row ({flips} "
                "flip): bitwise equal to the plain version")
    # Rays through shared edges: rows tie on t, the lowest row wins.
    eo, ed = _edge_rays(cornell, N_SPHERE_RAYS, 13, device)
    t_all, _, _ = dense._pe_block(eo[:16384], ed[:16384], tc.rows, 0.01)
    best = t_all.min(1).values
    ties = int((((t_all == best[:, None]).sum(1) > 1) & (best < 1e15)).sum())
    if ties < best.shape[0] // 200:
        raise AssertionError(f"K1 edge rays: only {ties} of {best.shape[0]} "
                             "tie")
    exact("closest_lean", "edge rays", lambda: dense.closest_lean(
        eo, ed, tc.rows, 0.01), lambda: dense._closest_plain(
        eo, ed, tc.rows, 0.01), tc.rows.shape[0], N_SPHERE_RAYS)
    for n in (N_RAYS, N_SPHERE_RAYS):
        eo, ed = _edge_rays(cornell, n, 13, device)
        etmax = torch.as_tensor(np.random.default_rng(14).uniform(
            0.0, 2000.0, n).astype(np.float32), device=device)
        for table in (tc.occ_rows, tm.occ_rows):
            exact("occluded", "edge rays", lambda table=table: dense.occluded(
                eo, ed, etmax, table, 0.01), lambda table=table:
                dense._occluded_plain(eo, ed, etmax, table, 0.01),
                table.shape[0], n)
    say("kernels", f"closest_lean and occluded (K1's, K2's dense bodies) on "
        f"{N_SPHERE_RAYS} rays aimed at shared edges of cornell_box.obj "
        f"({ties} of the first {best.shape[0]} tie on t): bitwise equal to "
        "the plain versions")
    # Zero rows padding a table to a multiple of 8, in one tile and in the
    # last of eight (the split leaves them out).
    for n in (N_RAYS, N_SPHERE_RAYS):
        shs = parked(sphere, ts, 2, n)[1]
        for what, table, (so, sd, st) in (
                ("the mixed box's subset", tm.occ_rows, shadows[n]),
                (f"a {DENSE_SUBSET_ROWS}-row subset", sub, shs)):
            padded = table.clone()
            padded[-3:] = 0.0
            exact("occluded", f"{what}, 3 zero rows",
                  lambda: dense.occluded(so, sd, st, padded, 0.01),
                  lambda: dense._occluded_plain(so, sd, st, padded, 0.01),
                  padded.shape[0], n)
    packed = dense.pack_tris(cornell)          # 32 rows + 480 zero rows
    exact("closest_lean", "cornell_box.obj's untrimmed table",
          lambda: dense.closest_lean(oc, dc, packed, 0.01),
          lambda: dense._closest_plain(oc, dc, packed, 0.01),
          packed.shape[0], N_SPHERE_RAYS)
    say("kernels", f"K2's dense body on subsets padded with zero rows "
        f"({tm.occ_rows.shape[0]}, {DENSE_SUBSET_ROWS} rows) and K1's on "
        f"cornell_box.obj's untrimmed {packed.shape[0]} rows: bitwise equal "
        f"to the plain versions")
    _check_closest_edges(device, cornell, tc, packed)
    _check_split_edges(records, device, tm, exact)
    say("kernels", f"the dense bodies' checks took "
        f"{time.perf_counter() - t0:.1f} s")


def _check_closest_edges(device, cornell, tc, packed):
    """K3's and K4's dense bodies at the edges of the closest sweep that K1's
    checks reach, at N_RAYS and N_SPHERE_RAYS with one lane in PARK_EVERY
    parked, bitwise against their plain versions: rays aimed at shared
    edges of ``cornell_box.obj`` (rows tie on t), its untrimmed table (480
    zero rows: two tiles, the second all zeros), and K3 at a tmax that is
    bit for bit the median hit's t (a ray whose nearest hit lies there
    misses)."""
    import torch
    from tpu_pt_torch.intersect import dense
    light = dense.light_vector(cornell)
    for n in (N_RAYS, N_SPHERE_RAYS):
        eo, ed = _edge_rays(cornell, n, 13, device)
        (eo, ed), _ = _park((eo, ed), (eo, ed, torch.ones_like(eo[:, 0])),
                            PARK_EVERY)
        lz1, lz2 = _light_samples(n, 16, device)
        t, _ = dense._closest_plain(eo, ed, tc.rows, 0.01)
        tmax = float(t[t < 1e15].median())
        at = t == tmax
        for what, table in (("edge rays", tc.rows),
                            ("edge rays, the untrimmed table", packed)):
            for clip in (600.0, tmax):
                out_k = dense.closest_full(eo, ed, table, 0.01, clip, True)
                out_p = dense._closest_plain(eo, ed, table, 0.01, clip, True,
                                             True)
                torch.cuda.synchronize()
                _compare_exact(f"closest_full on {what}, tmax {clip}", out_k,
                               out_p)
            if bool((out_k[0][at] < 1e15).any()):
                raise AssertionError(f"closest_full on {what}: a ray whose "
                                     f"nearest hit lies at tmax {tmax!r} hit")
            out_k = dense.closest_nee_lean(eo, ed, lz1, lz2, table,
                                           tc.occ_rows, light, 0.01)
            out_p = dense._closest_nee_plain(eo, ed, lz1, lz2, table,
                                             tc.occ_rows, light, 0.01)
            torch.cuda.synchronize()
            _compare_fused(f"closest_nee_lean on {what}", out_k, out_p)
        say("kernels", f"closest_full and closest_nee_lean (K3's, K4's dense "
            f"bodies) on {n} rays aimed at shared edges of cornell_box.obj "
            f"(one in {PARK_EVERY} parked), over its {tc.rows.shape[0]} rows "
            f"and its untrimmed {packed.shape[0]}, K3 at tmax 600 and at "
            f"{tmax!r} (the nearest hit of {int(at.sum())} rays, which "
            f"miss): bitwise equal to the plain versions")


def _check_split_edges(records, device, tm, exact):
    """K2's split (``tpt_occluded_split``, N_RAYS rays) at the edges of its
    cull, each call bitwise against ``dense._occluded_plain``: rays that
    graze a group's box (from a point of a face's plane, grown by a tenth
    of the box, along that plane), rays nearly in a row's plane (a point
    of its triangle moved off the plane by up to 1e-4, a normal component
    of up to 1e-6: t cancels), tmax of 0, past T_FAR (where a miss
    blocks) and NaN, a table with no group (twelve triangles that span
    the room) and a table of one group (six that span it and ten small
    ones in a corner). ``exact(name, what, kernel, plain, rows, n)``
    compares and records."""
    import numpy as np
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    t0 = time.perf_counter()
    r = np.random.default_rng(15)
    n = N_RAYS
    lo_room, hi_room = np.zeros(3), np.array([556.0, 548.8, 559.2])

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    def packed(verts):
        k = verts.shape[0]
        scene = tp.scene.build_scene_arrays(
            verts.reshape(-1, 3).astype(np.float32),
            np.arange(3 * k).reshape(k, 3), np.zeros(k, np.int64), [],
            device=device)
        return dense.pack_tris(scene)[:k].contiguous()

    def spanning(k):
        corner = r.integers(0, 2, (k, 3)).astype(bool)
        return np.stack([np.where(corner, hi_room, lo_room),
                         np.where(corner, lo_room, hi_room),
                         r.uniform(lo_room, hi_room, (k, 3))], 1)

    def graze(split):
        box = split.groups[:, 0:6].cpu().numpy().astype(np.float64)
        g = r.integers(0, box.shape[0], n)
        lo, hi = box[g, 0:3], box[g, 3:6]
        o = r.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo))
        axis = r.integers(0, 3, n)
        side = np.where(r.integers(0, 2, (n, 1)) == 0, lo, hi)
        o[np.arange(n), axis] = side[np.arange(n), axis]
        d = r.normal(size=(n, 3))
        d[np.arange(n), axis] = 0.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return t(o - d * r.uniform(0.0, 300.0, (n, 1))), t(d)

    def in_plane(table):
        host = table.cpu().double().numpy()
        verts = dense._row_vertices(host)
        ok = np.isfinite(verts).all((0, 2)) & (host[:, 0:3] != 0).any(1)
        pick = np.nonzero(ok)[0][r.integers(0, int(ok.sum()), n)]
        a, b = r.uniform(0.0, 1.0, (2, n, 1))
        a, b = (np.where(a + b > 1.0, 1.0 - a, a),
                np.where(a + b > 1.0, 1.0 - b, b))
        v0, v1, v2 = verts[:, pick]
        nrm = host[pick, 0:3]
        p = v0 + a * (v1 - v0) + b * (v2 - v0)
        p = p + nrm * r.uniform(-1e-4, 1e-4, (n, 1))
        d = np.cross(nrm, r.normal(size=(n, 3)))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = d + nrm * r.uniform(-1e-6, 1e-6, (n, 1))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return t(p - d * r.uniform(1.0, 200.0, (n, 1))), t(d)

    small = r.uniform(20.0, 60.0, (10, 1, 3)) + r.uniform(0.0, 15.0,
                                                           (10, 3, 3))
    tables = [("the mixed box's subset", tm.occ_rows),
              ("no group", packed(spanning(12))),
              ("one group", torch.cat([packed(spanning(6)),
                                       packed(small)]).contiguous())]
    counts = {}
    for what, table in tables:
        split = dense.row_split(table)
        counts[what] = split.groups.shape[0]
        sets = [("in plane", *in_plane(table))]
        if split.groups.shape[0]:
            sets.append(("grazing its boxes", *graze(split)))
        for kind, o, d in sets:
            tmax = t(r.uniform(0.0, 800.0, n))
            q = n // 8
            tmax[:q] = 0.0
            tmax[q:2 * q] = 2e16
            tmax[2 * q:3 * q] = float("nan")
            flags = exact("occluded", f"{what}, rays {kind}",
                          lambda: dense.occluded(o, d, tmax, table, 0.01),
                          lambda: dense._occluded_plain(o, d, tmax, table,
                                                        0.01),
                          table.shape[0], n)
            if bool(flags[:q].any()) or not bool(flags[q:2 * q].all()):
                raise AssertionError(f"K2 on {what}: an empty range blocked "
                                     "or a tmax past T_FAR did not")
    if counts != {"the mixed box's subset": 4, "no group": 0,
                  "one group": 1}:
        raise AssertionError(f"row splits: groups {counts}")
    say("kernels", f"occluded (K2's split, {n} rays) on rays grazing its "
        f"group boxes and nearly in its rows' planes, tmax 0, 2e16 and NaN, "
        f"over the mixed box's subset, a table of no group and one of one "
        f"group ({counts}): bitwise equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_kernels(device, big):
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, dense, kernel_module
    mixed = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    sphere = tp.load_scene(str(ASSETS / "cornell_box_sphere.obj"),
                           device=device)
    tm, ts = dense.prepare(mixed), dense.prepare(sphere)
    records = {"occluded": [], "closest_lean": []}
    _check_dense_bodies(records, device, mixed, tm, sphere, ts)

    def run(*args, **kw):
        _check_kernel(records, *args, **kw)

    def plain_dense(rows):
        return lambda o, d: dense._closest_plain(o, d, rows, 0.01)

    o, d, (so, sd, stmax) = _phase3_rays(mixed, device, 1, tm.rows,
                                         plain_dense(tm.rows), N_RAYS)
    lean = tm.rows
    run("closest_lean", lambda: dense.closest_lean(o, d, lean, 0.01),
        lambda: dense._closest_plain(o, d, lean, 0.01), lean.shape[0],
        _compare_closest, lambda out: _dense_work(o, lean, 8))

    occ = tm.occ_rows

    def compare_occ(name, k, p):
        if not torch.equal(k, p):
            raise AssertionError(f"{name}: flags differ on "
                                 f"{int((k != p).sum())} rays")
        return 0.0, f"{float(k.float().mean()):.4f} occluded"
    run("occluded", lambda: dense.occluded(so, sd, stmax, occ, 0.01),
        lambda: dense._occluded_plain(so, sd, stmax, occ, 0.01),
        occ.shape[0], compare_occ,
        lambda out: _dense_occluded_work(so, sd, stmax, occ))

    o2, d2, _ = _phase3_rays(sphere, device, 2, ts.rows,
                             plain_dense(ts.rows), N_RAYS)
    full = ts.rows
    run("closest_full",
        lambda: dense.closest_full(o2, d2, full, 0.01, 1e16, True),
        lambda: dense._closest_plain(o2, d2, full, 0.01, 1e16, True, True),
        full.shape[0], _compare_closest, lambda out: _dense_work(o2, full, 32))
    full_m = tm.rows
    run("closest_full",
        lambda: dense.closest_full(o, d, full_m, 0.01, 600.0, True),
        lambda: dense._closest_plain(o, d, full_m, 0.01, 600.0, True, True),
        full_m.shape[0], _compare_closest,
        lambda out: _dense_work(o, full_m, 32))
    _check_dense_walks(records, device, sphere, ts)

    # The big mesh at the big path's width, N_PLAIN_BIG lanes with one in
    # PARK_EVERY parked: K6 / K8 bitwise against their plain versions
    # (bounce origins from the plain version's hits), both timed there,
    # and the kernels timed at N_RAYS (bounce origins from K6's own hits).
    # The bound counts the node tests of a walk at each ray's final bound.
    if kernel_module(big) is not clustered:
        raise AssertionError("the big mesh must take the clustered kernels")
    tb = clustered.prepare(big)
    if tb.occ_rows is not None:
        raise AssertionError("the big mesh's shadow rays must take K8")
    rows, boxes, scale, nodes = tb.rows, tb.boxes, tb.scale, tb.nodes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clustered.cluster_tree(boxes)
    torch.cuda.synchronize()
    say("kernels", f"cluster_tree over {boxes.shape[0]} boxes: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock, boxes to "
        f"the host and the nodes back), {nodes.shape[0]} nodes, depth "
        f"{clustered.tree_depth(boxes.shape[0])}")

    def k6(o, d, fn=clustered.closest_clustered):
        return fn(o, d, rows, boxes, scale, 0.01, **_nodes_kw(fn, nodes))

    def k6_plain(o, d):
        return clustered._closest_clustered_plain(o, d, rows, 0.01)

    def k8(o, d, tmax, fn=clustered.occluded_clustered):
        return fn(o, d, tmax, rows, boxes, scale, 0.01, **_nodes_kw(fn, nodes))

    def k8_plain(o, d, tmax):
        return clustered._occluded_clustered_plain(o, d, tmax, rows, 0.01)

    def walk_work(o, d, bound, nbytes, occluded=None):
        tests = _walk_counts(o, d, bound, tb, occluded)[0]
        return _clustered_work(o, d, bound, rows, boxes, scale, nbytes,
                               occluded=occluded, box_tests=tests,
                               list_bytes=nodes.shape[0] * 32)

    rays = _phase3_rays(big, device, 3, rows, k6_plain, N_PLAIN_BIG)
    (ob, db), shadow = _park(rays[:2], rays[2], PARK_EVERY)
    oB, dB, shadow_B = _phase3_rays(big, device, 3, rows, k6, N_RAYS)
    torch.cuda.synchronize()
    run("closest_clustered", lambda: k6(ob, db), lambda: k6_plain(ob, db),
        rows.shape[0], _compare_exact,
        lambda out: walk_work(ob, db, out[0], 8), n=N_PLAIN_BIG, reps=10,
        plain_reps=2, at_n_rays=lambda: k6(oB, dB))
    run("occluded_clustered", lambda: k8(*shadow), lambda: k8_plain(*shadow),
        rows.shape[0], _compare_exact,
        lambda out: walk_work(*shadow, 1, occluded=out), n=N_PLAIN_BIG,
        reps=10, plain_reps=2, at_n_rays=lambda: k8(*shadow_B))
    t6n, _ = k6(ob, db)
    o8n = k8(*shadow)
    for what, counts in (
            ("K6", _walk_counts(ob, db, t6n, tb)),
            ("K8", _walk_counts(*shadow, tb, occluded=o8n))):
        tests, leaves, live = counts
        say("kernels", f"{what}'s walk at the final bound, {N_PLAIN_BIG} rays "
            f"({live} live): {tests / live:.2f} node tests and "
            f"{leaves / live:.2f} clusters swept per live ray (of "
            f"{boxes.shape[0]} clusters)")

    # The rest of the clustered kernels on the same rays: K6f (the full
    # carry, with u and v), K7 lean and full and K8b (a group of lanes a
    # ray over every box), each bitwise against its plain version, then
    # against K6 / K8. The bound is the least the card could take for the
    # function: every box tested per ray, and the rows of each box the ray
    # enters within its bound; the full carry writes 32 bytes per ray.
    def full(kernel, o, d):
        return kernel(o, d, rows, boxes, scale, 0.01, 1e16, True,
                      **_nodes_kw(kernel, nodes))

    def full_plain(o, d):
        return clustered._closest_clustered_full_plain(o, d, rows, 0.01,
                                                       1e16, True)

    def k7(o, d):
        return clustered.closest_clustered_b(o, d, rows, boxes, scale, 0.01)

    def k8b(o, d, tmax):
        return clustered.occluded_clustered_b(o, d, tmax, rows, boxes, scale,
                                              0.01)

    for name, kernel, plain, nbytes, wide in (
            ("closest_clustered_full",
             lambda: full(clustered.closest_clustered_full, ob, db),
             lambda: full_plain(ob, db), 32,
             lambda: full(clustered.closest_clustered_full, oB, dB)),
            ("closest_clustered_b", lambda: k7(ob, db),
             lambda: k6_plain(ob, db), 8, lambda: k7(oB, dB)),
            ("closest_clustered_full_b",
             lambda: full(clustered.closest_clustered_full_b, ob, db),
             lambda: full_plain(ob, db), 32,
             lambda: full(clustered.closest_clustered_full_b, oB, dB))):
        run(name, kernel, plain, rows.shape[0], _compare_exact,
            (lambda out, nbytes=nbytes: walk_work(ob, db, out[0], nbytes))
            if name == "closest_clustered_full" else
            (lambda out, nbytes=nbytes: _clustered_work(
                ob, db, out[0], rows, boxes, scale, nbytes)),
            n=N_PLAIN_BIG, reps=10, plain_reps=1, at_n_rays=wide)
    run("occluded_clustered_b", lambda: k8b(*shadow),
        lambda: k8_plain(*shadow), rows.shape[0], _compare_exact,
        lambda out: _clustered_work(shadow[0], shadow[1], shadow[2], rows,
                                    boxes, scale, 1, occluded=out),
        n=N_PLAIN_BIG, reps=10, plain_reps=1,
        at_n_rays=lambda: k8b(*shadow_B))
    # K8b at every width it is built for, against K8.
    want8 = k8(*shadow)
    for g in clustered.GROUPS:
        got = clustered.occluded_clustered_b(*shadow, rows, boxes, scale,
                                             0.01, group=g)
        torch.cuda.synchronize()
        if not torch.equal(got, want8):
            raise AssertionError(f"K8b at {g} lanes a ray differs from K8")
    say("kernels", f"K8b at {clustered.GROUPS} lanes a ray: bitwise equal to "
        f"K8 on {N_PLAIN_BIG} rays; the package picks "
        f"{clustered.occluded_b_group(N_PLAIN_BIG)} lanes at {N_PLAIN_BIG} "
        f"rays, {clustered.occluded_b_group(N_RAYS)} at {N_RAYS}")
    t6, row6 = k6(ob, db)
    f6 = full(clustered.closest_clustered_full, ob, db)
    # K7 lean and full at every width they are built for, against K6 / K6f.
    t0 = time.perf_counter()
    for g in clustered.GROUPS:
        for what, got, want in (
                ("K7 lean", clustered.closest_clustered_b(
                    ob, db, rows, boxes, scale, 0.01, group=g), (t6, row6)),
                ("K7 full", clustered.closest_clustered_full_b(
                    ob, db, rows, boxes, scale, 0.01, 1e16, True, group=g),
                 f6)):
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{what} at {g} lanes a ray differs "
                                     "from K6 / K6f")
    say("kernels", f"K7 lean and full at {clustered.GROUPS} lanes a ray: "
        f"bitwise equal to K6 / K6f on {N_PLAIN_BIG} rays; the package "
        f"picks {clustered.closest_b_group(N_PLAIN_BIG)} lanes at "
        f"{N_PLAIN_BIG} rays, {clustered.closest_b_group(N_RAYS)} at "
        f"{N_RAYS} ({time.perf_counter() - t0:.1f} s)")
    # K7 on clusters of 256 rows: its groups read rows through the cache,
    # and no row buffer caps a cluster. Against the plain versions on the
    # same table, and t against K6's on the 128-row one.
    t0 = time.perf_counter()
    cluster_rows = clustered.CLUSTER
    clustered.CLUSTER = 256
    try:
        rows2, boxes2 = clustered.pack_tris_clustered(big)
    finally:
        clustered.CLUSTER = cluster_rows
    scale2 = clustered.box_scale(boxes2)
    for what, got, want in (
            ("K7 lean", clustered.closest_clustered_b(
                ob, db, rows2, boxes2, scale2, 0.01),
             clustered._closest_clustered_plain(ob, db, rows2, 0.01)),
            ("K7 full", clustered.closest_clustered_full_b(
                ob, db, rows2, boxes2, scale2, 0.01, 1e16, True),
             clustered._closest_clustered_full_plain(ob, db, rows2, 0.01,
                                                     1e16, True))):
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{what} on clusters of 256 rows differs "
                                 "from its plain version")
        if not torch.equal(got[0], t6):
            raise AssertionError(f"{what} on clusters of 256 rows: t differs "
                                 "from K6's on clusters of 128")
    say("kernels", f"K7 lean and full on {boxes2.shape[0]} clusters of 256 "
        f"rows: bitwise equal to their plain versions on {N_PLAIN_BIG} rays, "
        f"t equal to K6's ({time.perf_counter() - t0:.1f} s)")
    del rows2, boxes2
    ids = torch.where(t6 < 1e15, rows[row6.long(), 15], 0.0).to(torch.int32)
    for what, a, b in (
            ("K7 lean against K6", k7(ob, db), (t6, row6)),
            ("K6f against K6 (t, id of the row)", f6[:2], (t6, ids)),
            ("K7 full against K6f",
             full(clustered.closest_clustered_full_b, ob, db), f6),
            ("K8b against K8", (k8b(*shadow),), (k8(*shadow),))):
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: the kernels differ")
        say("kernels", f"{what}: bitwise equal on {N_PLAIN_BIG} rays")
    if not bool(f6[4].any()) or not bool(f6[5].any()):
        raise AssertionError("K6f returned no u, v")

    _check_ablations(records, tb, (ob, db), shadow, (oB, dB), shadow_B,
                     (t6, row6), k8(*shadow))

    # The exact inputs of one K6 and one K8 call of a bench_big frame,
    # through each wrapper and its plain version.
    _hold_recorded(records, _record_big_calls(big, device), "bench_big")
    return records


def _render(scene, device, frames, tap=None, **cfg_kw):
    """Render ``frames`` progressive frames; returns (accum, u8, per-frame
    [(seconds, rays, stats)]). ``tap`` (a context manager) is entered
    around the first frame only, the warm-up."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    cfg = tp.RenderConfig(**cfg_kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    accum = init_accum(cfg, device=device)
    out = []
    u8 = None
    for f in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (tap if tap is not None and f == frames[0]
              else contextlib.nullcontext()):
            accum, u8, stats = render_frame(scene, cam, cfg, f, accum)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    int(stats.rays_traced) + int(stats.shadow_rays), stats))
    return accum, u8, out


def _check_frame(tag, accum, per_frame):
    import torch
    from tpu_pt_torch.render import NOT_DONE
    if not bool(torch.isfinite(accum).all()):
        raise AssertionError(f"{tag}: non-finite pixels")
    for _, rays, stats in per_frame:
        if int(stats.done_histogram[NOT_DONE]) != 0:
            raise AssertionError(f"{tag}: NOT_DONE paths remain")
        if rays <= 0:
            raise AssertionError(f"{tag}: no rays traced")


def phase_goldens(device):
    import numpy as np
    import tpu_pt_torch as tp
    from tpu_pt_torch import film
    scene = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    worst = 0.0
    for name, overrides in GOLDEN_MODES:
        kw = {**dict(width=128, height=128, spp=32, max_depth=4), **overrides}
        _zero_counters()
        accum, u8, per = _render(scene, device, [0], **kw)
        counts = _read_counters()
        _check_frame(name, accum, per)
        # The mixed box's closest hits go through K1's walk.
        if counts["closest_lean_tree"] <= 0 or counts["closest_lean"]:
            raise AssertionError(f"{name}: launches {counts}")
        golden = film.read_png(str(GOLDENS / f"{name}.png"))
        err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                        golden.astype(np.float32) / 255.0)
        say("goldens", f"{name}: RMSE {err:.5f} ({per[0][0] * 1e3:.1f} ms)")
        if not err < GOLDEN_RMSE:
            raise AssertionError(f"{name}: RMSE {err} >= {GOLDEN_RMSE}")
        worst = max(worst, err)
    # Scene JSON: analytic primitives and curves beside the triangles'
    # kernels (IS + NEE).
    for name, scene_file in JSON_GOLDENS:
        scene = tp.load_scene(str(ASSETS / scene_file), device=device)
        _zero_counters()
        accum, u8, per = _render(scene, device, [0], width=128, height=128,
                                 spp=32, max_depth=4,
                                 use_importance_sampling=True,
                                 use_direct_lighting=True)
        counts = _read_counters()
        _check_frame(name, accum, per)
        if counts["closest_lean"] <= 0 or counts["occluded"] <= 0:
            raise AssertionError(f"{name}: launches {counts}")
        golden = film.read_png(str(GOLDENS / f"{name}.png"))
        err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                        golden.astype(np.float32) / 255.0)
        say("goldens", f"{name} ({scene_file}: "
            f"{0 if scene.prims is None else scene.prims.count} primitives, "
            f"{0 if scene.curves is None else scene.curves.count} curve "
            f"segments): RMSE {err:.5f} ({per[0][0] * 1e3:.1f} ms)")
        if not err < GOLDEN_RMSE:
            raise AssertionError(f"{name}: RMSE {err} >= {GOLDEN_RMSE}")
        worst = max(worst, err)
    return worst


def _launch_counters():
    from tpu_pt_torch.intersect import ablations, clustered, dense, instanced
    return (dense.LAUNCHES, clustered.LAUNCHES, instanced.LAUNCHES,
            ablations.LAUNCHES)


def _zero_counters():
    for counter in _launch_counters():
        counter.update(dict.fromkeys(counter, 0))


def _read_counters() -> dict:
    return {k: n for c in _launch_counters() for k, n in c.items()}


def phase_main_path(device, smi, big, records):
    """Each main-path run with the launch counters zeroed just before it
    and read just after; returns the launches summed per kernel, and for
    each run of FUSED_TWINS and for the big-mesh run (tag -> (run, accum,
    s/frame, Mrays/s)). A run of WALK_RUNS launches each of its walks once
    per round and the kernels it bans never; its warm-up frame records one
    call of each walk, held bitwise against its plain version and against
    its dense body, timed in interleaved pairs."""
    import tpu_pt_torch as tp
    from tpu_pt_torch import rng
    from tpu_pt_torch.intersect import dense
    scenes = {BIG_MESH: big}
    launches = dict.fromkeys(KERNELS, 0)
    twins = {}
    for run in MAIN_RUNS:
        tag, scene_file, frames, timed, kw, expect = run
        if scene_file not in scenes:
            scenes[scene_file] = tp.load_scene(str(ASSETS / scene_file),
                                               device=device)
        # Other runs never launch the walks of K1-K4.
        once, banned, label = WALK_RUNS.get(tag, ((), tuple(DENSE_BODY),
                                                  None))
        tap = _Tap(once) if once else None
        _zero_counters()
        drawn = dict(rng.LAUNCHES)
        accum, _, per = _render(scenes[scene_file], device, frames, tap=tap,
                                use_direct_lighting=True,
                                use_importance_sampling=True, **kw)
        counts = _read_counters()
        _check_frame(tag, accum, per)
        # pixelq draws once a bounce round and once for its jitter, plus
        # each frame's first fill: fewer launches would mean a draw took
        # the plain version.
        rounds = sum(int(p[2].wavefront_iterations) for p in per)
        drawn = {k: rng.LAUNCHES[k] - n for k, n in drawn.items()}
        if drawn != {"uniform": rounds + len(frames),
                     "bounce_uniforms": rounds}:
            raise AssertionError(f"{tag}: RNG launches {drawn} in {rounds} "
                                 f"rounds of {len(frames)} frames")
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        iters = [int(p[2].wavefront_iterations) for p in per[-timed:]]
        say("main", f"{tag}: {sec / timed * 1e3:.1f} ms/frame, "
            f"{rays / sec / 1e6:.3f} Mrays/s over {timed} frame(s), "
            f"{rays // timed} rays/frame, rounds {iters}; launches "
            f"{ {k: n for k, n in counts.items() if n} }; RNG {drawn}; "
            f"{smi}")
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"{tag}: {k} never launched")
        for k in once:
            if counts[k] != rounds:
                raise AssertionError(f"{tag}: {k} launched {counts[k]} "
                                     f"times in {rounds} rounds")
        for k in banned + SHADOW_LIST_KERNELS:
            if counts[k]:
                raise AssertionError(f"{tag}: {k} launched {counts[k]} "
                                     "times")
        for k, n in counts.items():
            launches[k] += n
        if tag == BIG_TAG or any(tag == t[0] for t in FUSED_TWINS):
            twins[tag] = (run, accum, sec / timed, rays / sec / 1e6)
        if not once:
            continue
        _hold_recorded(records, tap.picked, f"{tag} warm-up")
        tables = dense.prepare(scenes[scene_file])
        for (name, _), (args, _) in tap.picked.items():
            _walk_against_dense(
                records, name, f"{name} (a {tag} call)",
                lambda name=name, args=args: getattr(dense, name)(*args),
                functools.partial(_dense_body_of, name, args, tables), label)
    say("main", f"kernel launches on the main path: {launches}")
    return launches, twins


def _dense_body_of(name: str, args, tables):
    """The dense body of walk ``name`` (DENSE_BODY) on a recorded walk
    call's own rays, over the dense tables ``tables`` of the scene."""
    from tpu_pt_torch.intersect import dense
    o, d = args[0], args[1]
    if name == "closest_full_tree":
        tmin, tmax, want_uv = args[7:10]
        return dense.closest_full(o, d, tables.rows, tmin, tmax, want_uv)
    if name == "occluded_tree":
        return dense.occluded(o, d, args[2], tables.occ_rows, args[8])
    if name == "closest_lean_tree":
        return dense.closest_lean(o, d, tables.rows, args[7])
    if name == "closest_nee_lean_tree":
        lz1, lz2, light, tmin = args[2], args[3], args[14], args[15]
        return dense.closest_nee_lean(o, d, lz1, lz2, tables.rows,
                                      tables.occ_rows, light, tmin)
    raise ValueError(f"{name} has no dense body")


def phase_cross_check(big):
    """The big mesh at CROSS_CHECK on the CPU (the kernels' plain versions)
    and on the card (the kernels): the frames agree within the bound of
    tests/test_torch_render.py."""
    out = []
    for scene in (big.to("cpu"), big):
        t0 = time.perf_counter()
        accum, _, per = _render(scene, scene.device, [0],
                                intersector="dense",
                                use_direct_lighting=True,
                                use_importance_sampling=True, **CROSS_CHECK)
        _check_frame(f"cross-check on {scene.device}", accum, per)
        out.append((accum.cpu(), time.perf_counter() - t0))
    (cpu_img, cpu_s), (card_img, card_s) = out
    line = _image_bound("the CPU and card big-mesh frames", cpu_img, card_img,
                        PIXEL_TOL, PIXEL_SHARE)
    say("cross-check", f"big mesh {CROSS_CHECK}: CPU {cpu_s:.1f} s, "
        f"card {card_s:.2f} s; {line}")


# --------------------------------------------------------------------------
# K6f / K7 / K8b on their main paths, the huge mesh and the LBVH
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _env(**variables):
    """The JAX package's dispatch variables, set for the block."""
    import os
    saved = {k: os.environ.get(k) for k in variables}
    os.environ.update(variables)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _image_bound(tag, a, b, tol, share_max):
    """Two accumulators within (mean |diff| < tol, share of pixels beyond
    tol <= share_max); returns the line to print."""
    diff = (a - b).abs().amax(dim=-1)
    share = float((diff > tol).float().mean())
    if not (float(diff.mean()) < tol and share <= share_max):
        raise AssertionError(f"{tag}: the frames disagree (mean |diff| "
                             f"{float(diff.mean()):.3e}, {share:.4f} of "
                             f"pixels beyond {tol})")
    return (f"mean |diff| {float(diff.mean()):.3e}, {share:.4f} of pixels "
            f"beyond {tol}, max {float(diff.max()):.3e}")


def phase_big_variants(device, smi, big, lean, records):
    """bench_big's frame through the other clustered kernels (BIG_VARIANTS),
    counters zeroed just before each run and read just after: the kernels
    the variables select launch, the ones they replace never, and the
    accumulator equals the lean run's (``lean``: its twins entry) bit for
    bit, since the path tracer reads no u, v. Then pbr_big.glb's Whitted
    frame under TPT_LEAN_UV=0 (K6f with u, v) against the lean one. Each
    warm-up frame records one call of each new wrapper, held bitwise
    against its plain version. Returns the launches summed per kernel."""
    import torch
    import tpu_pt_torch as tp
    launches = dict.fromkeys(KERNELS, 0)
    (_, _, frames, timed, kw, _), lean_accum, lean_s, lean_mr = lean
    for what, variables, expect, banned in BIG_VARIANTS:
        tap = _Tap(NEW_WRAPPERS)
        with _env(**variables):
            _zero_counters()
            accum, _, per = _render(big, device, frames, tap=tap,
                                    use_direct_lighting=True,
                                    use_importance_sampling=True, **kw)
            counts = _read_counters()
        tag = f"{BIG_TAG}, {what} {variables}"
        _check_frame(tag, accum, per)
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        same = torch.equal(accum, lean_accum)
        say("main", f"{tag}: {sec / timed * 1e3:.1f} ms/frame, "
            f"{rays / sec / 1e6:.3f} Mrays/s over {timed} frame(s) (lean: "
            f"{lean_s * 1e3:.1f} ms/frame, {lean_mr:.3f} Mrays/s); launches "
            f"{ {k: n for k, n in counts.items() if n} }; accumulator "
            f"bitwise equal to the lean run's: {same}; {smi}")
        rounds = sum(int(p[2].wavefront_iterations) for p in per)
        for k in expect:
            if counts[k] != rounds:
                raise AssertionError(f"{tag}: {k} launched {counts[k]} "
                                     f"times in {rounds} rounds")
        for k in banned:
            if counts[k]:
                raise AssertionError(f"{tag}: {k} launched")
        builds = LIST_BUILDS.get(what, 0) * rounds
        if counts["stream_lists"] != builds:
            raise AssertionError(f"{tag}: stream_lists launched "
                                 f"{counts['stream_lists']} times, not "
                                 f"{builds}")
        for k, per_round in (("pair_schedule", PAIR_SCHEDULES),
                             ("cbin_schedule", CBIN_SCHEDULES)):
            schedules = per_round.get(what, 0) * rounds
            if counts[k] != schedules:
                raise AssertionError(f"{tag}: {k} launched {counts[k]} "
                                     f"times, not {schedules}")
        if not same:
            raise AssertionError(f"{tag}: the frame differs from the lean "
                                 "one (bound: bitwise)")
        for k, n in counts.items():
            launches[k] += n
        _hold_recorded(records, tap.picked, f"bench_big ({what})",
                       all_parked_ok=("closest_streamed", "stream_lists")
                       if "TPT_CBIN" in variables else ())
        for k in expect:
            if k in NEW_WRAPPERS and not any(n == k for n, _ in tap.picked):
                raise AssertionError(f"{tag}: no {k} call was recorded")

    # pbr_big.glb (Whitted, u and v wanted): lean K6 + gather against the
    # full carry K6f. u and v differ by float association only.
    ws = tp.load_gltf(str(ASSETS / "pbr_big.glb"), device=device)
    out = {}
    for what, variables in (("lean", {}),
                            ("full carry", dict(TPT_LEAN_UV="0"))):
        tap = _Tap(NEW_WRAPPERS)
        with _env(**variables):
            _zero_counters()
            accum, _, per = _render_whitted(ws, device, WHITTED_VIEW, [0, 1],
                                            tap=tap, **WHITTED_BENCH)
            counts = _read_counters()
        _check_frame(f"pbr_big {what}", accum, per)
        out[what] = (accum.clone(), counts, per[1][0])
        for k, n in counts.items():
            launches[k] += n
        _hold_recorded(records, tap.picked, f"pbr_big ({what})")
    counts = out["full carry"][1]
    if counts["closest_clustered_full"] <= 0 or counts["closest_clustered"] \
            or out["lean"][1]["closest_clustered_full"]:
        raise AssertionError(f"pbr_big under TPT_LEAN_UV=0: launches {counts}")
    line = _image_bound("pbr_big full carry vs lean", out["full carry"][0],
                        out["lean"][0], WHITTED_TOL, WHITTED_SHARE)
    say("whitted", f"pbr_big 512^2 x 8 spp under TPT_LEAN_UV=0: "
        f"{out['full carry'][2] * 1e3:.1f} ms/frame (lean "
        f"{out['lean'][2] * 1e3:.1f}); launches "
        f"{ {k: n for k, n in counts.items() if n} } in 2 frames; against "
        f"the lean frame: {line}; {smi}")
    return launches


def phase_huge_mesh(device, smi, records):
    """The 1M-triangle mesh: written, loaded (with the seconds each step
    took); one K6 and one K8 call at N_PLAIN_BIG rays (one lane in
    PARK_EVERY parked) bitwise against K7 / K8b on the same rays, the
    walks timed; and bench_big's frame through K6 + K8 and through
    K7 + K8b."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, kernel_module, lbvh
    from tpu_pt_torch.scene import arrays, objloader
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "tools" / "make_assets.py"),
                    "--huge", "--out", str(BUILD_ASSETS)], check=True,
                   capture_output=True, timeout=900)
    written = time.perf_counter() - t0
    spent = {}

    def timed(module, name):
        fn = getattr(module, name)

        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out
        setattr(module, name, call)
        return fn
    saved = [(m, n, timed(m, n)) for m, n in (
        (objloader, "load_obj"), (arrays, "median_split_order"),
        (arrays, "nee_occluder_index"), (lbvh, "build_lbvh_host"))]
    try:
        t0 = time.perf_counter()
        scene = tp.load_scene(str(BUILD_ASSETS / HUGE_MESH), device=device)
        torch.cuda.synchronize()
        loaded = time.perf_counter() - t0
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    if kernel_module(scene) is not clustered or scene.num_tris < HUGE_MIN_TRIS:
        raise AssertionError("the huge mesh must take the clustered kernels")
    t0 = time.perf_counter()
    tables = clustered.prepare(scene)
    torch.cuda.synchronize()
    packed = time.perf_counter() - t0
    say("huge", f"{HUGE_MESH}: {scene.num_tris} triangles, "
        f"{tables.boxes.shape[0]} clusters, {scene.num_occluders} NEE "
        f"occluders; written in {written:.1f} s; load_scene {loaded:.1f} s "
        f"(parsing {spent['load_obj']:.1f} s, ordering "
        f"{spent['median_split_order']:.1f} s, occluder analysis "
        f"{spent['nee_occluder_index']:.1f} s, native LBVH build on the "
        f"host {spent['build_lbvh_host']:.1f} s); packing "
        f"{packed * 1e3:.1f} ms "
        f"(the cluster tree included)")
    table = (tables.rows, tables.boxes, tables.scale, 0.01)

    def k6(o, d, fn=clustered.closest_clustered):
        return fn(o, d, *table, **_nodes_kw(fn, tables.nodes))

    def k8(o, d, tmax, fn=clustered.occluded_clustered):
        return fn(o, d, tmax, *table[:3], 0.01,
                  **_nodes_kw(fn, tables.nodes))

    rays = _phase3_rays(scene, device, 3, tables.rows, k6, N_PLAIN_BIG)
    (oh, dh), sh = _park(rays[:2], rays[2], PARK_EVERY)
    for what, a, b in (
            ("K6 against K7 lean", k6(oh, dh),
             k6(oh, dh, clustered.closest_clustered_b)),
            ("K8 against K8b", (k8(*sh),),
             (k8(*sh, clustered.occluded_clustered_b),))):
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"huge mesh, {what}: the kernels differ")
        say("huge", f"{what}: bitwise equal on {N_PLAIN_BIG} rays")
    ms = gpu_ms(lambda: k6(oh, dh, clustered.closest_clustered_b), 5)
    records["closest_clustered_b"][0]["ms_huge"] = ms
    say("huge", f"K7 lean at {N_PLAIN_BIG} rays: {ms:.4f} ms a call, every "
        f"one of {tables.boxes.shape[0]} boxes tested per ray")
    for what, name, call, counts in (
            ("K6", "closest_clustered", lambda: k6(oh, dh),
             _walk_counts(oh, dh, k6(oh, dh)[0], tables)),
            ("K8", "occluded_clustered", lambda: k8(*sh),
             _walk_counts(*sh, tables, occluded=k8(*sh)))):
        tests, leaves, live = counts
        ms = gpu_ms(call, 10)
        records[name][0]["ms_huge"] = ms
        say("huge", f"{what}'s walk at the final bound, {N_PLAIN_BIG} rays "
            f"({live} live): {ms:.4f} ms a call, {tests / live:.2f} node "
            f"tests and {leaves / live:.2f} clusters swept per live ray (of "
            f"{tables.boxes.shape[0]} clusters)")
    del tables
    launches = dict.fromkeys(KERNELS, 0)
    frames = {}
    for what, variables, expect in (
            ("K6 + K8", {}, ("closest_clustered", "occluded_clustered")),
            ("K7 + K8b", dict(TPT_INKB="1"),
             ("closest_clustered_b", "occluded_clustered_b"))):
        with _env(**variables):
            _zero_counters()
            accum, _, per = _render(scene, device, [0, 1],
                                    use_direct_lighting=True,
                                    use_importance_sampling=True, **BENCH_BIG)
            counts = _read_counters()
        _check_frame(f"huge mesh {what}", accum, per)
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"huge mesh {what}: {k} never launched")
        for k, n in counts.items():
            launches[k] += n
        frames[what] = accum.clone()
        say("huge", f"bench_big's frame through {what}: frame 1 "
            f"{per[1][0] * 1e3:.1f} ms, "
            f"{per[1][1] / per[1][0] / 1e6:.3f} Mrays/s, rounds "
            f"{int(per[1][2].wavefront_iterations)}; launches "
            f"{ {k: n for k, n in counts.items() if n} } in 2 frames; {smi}")
    if not torch.equal(frames["K6 + K8"], frames["K7 + K8b"]):
        raise AssertionError("the huge mesh's frames differ between the two "
                             "designs")
    say("huge", "the two designs' accumulators are bitwise equal")
    return launches


def phase_lbvh(device, smi, big):
    """The LBVH on the card against the kernels, on the big mesh."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch import rng
    from tpu_pt_torch.intersect import clustered, lbvh
    from tpu_pt_torch.render import CameraArrays, camera_rays
    if big.bvh is None:
        raise AssertionError("load_scene must attach the LBVH")
    tables = clustered.prepare(big)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    side = LBVH_CHECK["width"]
    pix = torch.arange(side * side, device=device)
    jx, jy = rng.uniform2(pix, 0, 0, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, side, side, jx, jy)
    hb = lbvh.intersect_closest(big, o, d)
    hd = clustered.closest_hit(tables, o, d)
    hit_same = float((hb.hit == hd.hit).float().mean())
    both = hb.hit & hd.hit
    id_same = float((hb.tri == hd.tri)[both].float().mean())
    dt = float((hb.t - hd.t)[both].abs().max())
    say("lbvh", f"{side}^2 primary rays on the big mesh ({big.bvh.num_nodes} "
        f"nodes): hit / miss agree on {hit_same:.4f}, ids on {id_same:.4f} "
        f"of the {int(both.sum())} hits, max |dt| {dt:.3e}")
    if hit_same < ROW_AGREE or id_same < ROW_AGREE or dt > 1e-2:
        raise AssertionError("the LBVH walk and the kernels disagree")
    imgs = {}
    for backend in ("bvh", "dense"):
        accum, _, per = _render(big, device, [0], intersector=backend,
                                use_direct_lighting=True,
                                use_importance_sampling=True, **LBVH_CHECK)
        _check_frame(f"big mesh through {backend}", accum, per)
        imgs[backend] = (accum.clone(), per[0][0],
                         int(per[0][2].wavefront_iterations))
    line = _image_bound("bvh vs dense", imgs["bvh"][0], imgs["dense"][0],
                        PIXEL_TOL, PIXEL_SHARE)
    say("lbvh", f"big mesh {LBVH_CHECK}: bvh {imgs['bvh'][1]:.2f} s, dense "
        f"{imgs['dense'][1]:.2f} s, {imgs['bvh'][2]} rounds; {line}")
    rays = _phase3_rays(big, device, 3, tables.rows,
                        lambda o, d: clustered.closest_clustered(
                            o, d, tables.rows, tables.boxes, tables.scale,
                            0.01, nodes=tables.nodes), N_PLAIN_BIG)
    (ob, db), _ = _park(rays[:2], rays[2], PARK_EVERY)
    lbvh.intersect_closest(big, ob, db)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lbvh.intersect_closest(big, ob, db)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    k6_ms = gpu_ms(lambda: clustered.closest_clustered(
        ob, db, tables.rows, tables.boxes, tables.scale, 0.01,
        nodes=tables.nodes), 5)
    say("lbvh", f"one closest call at {N_PLAIN_BIG} rays (one in "
        f"{PARK_EVERY} parked): LBVH walk {walk_s * 1e3:.1f} ms (host "
        f"clock; the end of the walk is read every {lbvh.CUDA_CHECK_EVERY} "
        f"steps), K6 {k6_ms:.4f} ms; {smi}")


# --------------------------------------------------------------------------
# The fused closest-hit + NEE kernels K4 / K5 and the entry points
# --------------------------------------------------------------------------

def _light_samples(n: int, seed: int, device):
    """(lz1, lz2) [n] from the counter RNG, as _bounce draws them."""
    import torch
    from tpu_pt_torch import rng
    pix = torch.arange(n, device=device)
    lz1, lz2, _, _ = rng.uniform4(pix, 0, seed, rng.STREAM_BOUNCE_B)
    return lz1.contiguous(), lz2.contiguous()


def _fused_work(o, d, lz1, lz2, light, rows, occ_rows, out, out_bytes: int):
    """A fused call needs the closest-hit sweep's every (ray, row) pair,
    then the any-hit sweep of the shadow ray (traced on every lane, from
    the kernel's hits) up to its first blocking row. Bytes: rays and light
    samples in, both tables, ``out_bytes`` per ray out."""
    from tpu_pt_torch.intersect import dense
    flops, _ = _dense_work(o, rows, 0)
    so, sd, st = dense._shadow_rays(o, d, out[0], lz1, lz2, light)
    occ_flops, _ = _dense_occluded_work(so, sd, st, occ_rows)
    n = o.shape[0]
    return (flops + occ_flops,
            n * 32 + (rows.shape[0] + occ_rows.shape[0]) * 64 + 36
            + n * out_bytes)


def _closest_walk_work(o, d, bound, kd):
    """The closest half of a walk of a kd copy (K3, K5) at each ray's
    final ``bound``: every ray sweeps the copy's top rows, then tests the
    tree's nodes and sweeps the clusters reached there (``_walk_counts``).
    Returns (ray-row pairs, node tests, clusters swept, live rays)."""
    cluster = (kd.rows.shape[0] - kd.top) // kd.boxes.shape[0]
    tests, leaves, live = _walk_counts(o, d, bound, kd)
    return o.shape[0] * kd.top + leaves * cluster, tests, leaves, live


def _shadow_walk_work(so, sd, st, kd, occ):
    """The any-hit walk of a kd copy (K2, K5's shadow ray) with bound
    ``st``: nothing when (tmin, st) is empty; else the top rows up to the
    first blocking one and, when none blocks, the tree's nodes and the
    clusters reached (one path to one cluster when a cluster row blocks:
    ``occ``, the walk's flags). Returns (ray-row pairs, node tests,
    clusters swept)."""
    cluster = (kd.rows.shape[0] - kd.top) // kd.boxes.shape[0]
    top_pairs, walked = _top_any_hit(so, sd, st, kd.rows[:kd.top])
    tests, leaves, _ = _walk_counts(so[walked], sd[walked], st[walked], kd,
                                    occluded=occ[walked])
    return top_pairs + leaves * cluster, tests, leaves


def _top_any_hit(so, sd, st, rows):
    """A group's any-hit sweep of ``rows`` in order (a kd copy's top rows,
    or a subset with no copy): nothing when (tmin, st) is empty, else the
    rows up to the first blocking one. Returns (ray-row pairs, [N] open
    and not blocked there)."""
    import torch
    from tpu_pt_torch.intersect import dense
    n, top = so.shape[0], rows.shape[0]
    open_ = st > 0.01
    pairs, unblocked = 0, open_.clone()
    if top:
        for a in range(0, n, 16384):
            sl = slice(a, a + 16384)
            t, _, _ = dense._pe_block(so[sl], sd[sl], rows, 0.01)
            block = (t < st[sl, None]) & (rows[None, :, 13] < 0.5)
            first = block.to(torch.int32).argmax(1)
            need = torch.where(block.any(1), first + 1, top)
            pairs += int(torch.where(open_[sl], need, 0).sum())
            unblocked[sl] &= ~block.any(1)
    return pairs, unblocked


def _kd_bytes(kd) -> int:
    """The bytes of a kd copy a walk reads once: rows, boxes, nodes."""
    return (kd.rows.shape[0] * 64 + kd.boxes.shape[0] * 32
            + kd.nodes.shape[0] * 32)


def _fused_walk_work(o, d, lz1, lz2, light, kd, out, out_bytes: int):
    """K5's walk at each ray's final bound: its closest half
    (``_closest_walk_work``), then its shadow ray's any-hit walk
    (``_shadow_walk_work``), from the kernel's hits. Bytes: rays and light
    samples in, the kd copy once, ``out_bytes`` per ray out. Returns
    (operations, bytes, node tests, clusters swept, live rays)."""
    from tpu_pt_torch.intersect import dense
    pairs, tests, leaves, live = _closest_walk_work(o, d, out[0], kd)
    so, sd, st = dense._shadow_rays(o, d, out[0], lz1, lz2, light)
    s_pairs, s_tests, s_leaves = _shadow_walk_work(so, sd, st, kd, out[-1])
    flops = (pairs + s_pairs) * PAIR_FLOPS + (tests + s_tests) * BOX_FLOPS
    nbytes = o.shape[0] * (32 + out_bytes) + _kd_bytes(kd) + 36
    return flops, nbytes, tests + s_tests, leaves + s_leaves, live


def _lean_walk_work(o, d, lz1, lz2, light, tables, out):
    """K1's walk (``out`` of 2) or K4's (``out`` of 3) at each ray's final
    bound: the closest half (``_closest_walk_work``) and K4's shadow ray,
    the any-hit walk of the subset's copy (``_shadow_walk_work``) or the
    sweep of its rows (``_top_any_hit``). Bytes: rays (and light samples)
    in, the copies once, (t, row[, flag]) out. Returns (operations, bytes,
    node tests per live ray, clusters swept per live ray)."""
    from tpu_pt_torch.intersect import dense
    kd, occ_kd = tables.kd, tables.occ_kd
    pairs, tests, leaves, live = _closest_walk_work(o, d, out[0], kd)
    nbytes = o.shape[0] * (24 + 8) + _kd_bytes(kd)
    if len(out) == 3:
        so, sd, st = dense._shadow_rays(o, d, out[0], lz1, lz2, light)
        if occ_kd is None:
            s_pairs, _ = _top_any_hit(so, sd, st, tables.occ_rows)
            s_tests = s_leaves = 0
            nbytes += tables.occ_rows.shape[0] * 64
        else:
            s_pairs, s_tests, s_leaves = _shadow_walk_work(so, sd, st, occ_kd,
                                                           out[-1])
            nbytes += _kd_bytes(occ_kd)
        pairs, tests, leaves = pairs + s_pairs, tests + s_tests, \
            leaves + s_leaves
        nbytes += o.shape[0] * 9 + 36
    return (pairs * PAIR_FLOPS + tests * BOX_FLOPS, nbytes, tests / live,
            leaves / live)


def _check_lean_walks(records, device):
    """K1's and K4's walks on the mixed and monkey boxes (LEAN_BOXES) at
    N_RAYS camera and bounce rays with one lane in PARK_EVERY parked,
    light samples from the counter RNG: each walk bitwise against its
    plain version, timed, its bound from its own node tests and reached
    clusters beside the dense count; then against its dense body on the
    same inputs, bit for bit (the occlusion flag on every lane), timed in
    interleaved pairs; then on N_RAYS // 4 rays aimed at shared edges,
    where rows tie on t, against the plain versions and the dense bodies.
    On the monkey box, whose subset has a copy, K2's walk against its
    dense body too. Also the host time of ``dense.prepare`` and of its
    kd copies."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    for box, scene_file, width in LEAN_BOXES:
        scene = tp.load_scene(str(ASSETS / scene_file), device=device)
        tables, light = dense.prepare(scene), dense.light_vector(scene)
        rows, occ, kd = tables.rows, tables.occ_rows, tables.kd
        if kd is None or rows.shape[0] > dense.LEAN_MAX_TRIS:
            raise AssertionError(f"{scene_file}: K1 and K4 do not walk it")
        if box == "mixed":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                dense.prepare(scene)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(10):
                dense.kd_tables(scene)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            say("kernels", f"dense.prepare of the mixed box: "
                f"{(t1 - t0) * 100:.3f} ms a call (host clock), of which its "
                f"kd copy {(t2 - t1) * 100:.3f} ms (dense.kd_tables)")
        o, d, shadow = _phase3_rays(
            scene, device, 16, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), N_RAYS)
        (o, d), shadow = _park((o, d), shadow, PARK_EVERY)
        lz1, lz2 = _light_samples(N_RAYS, 16, device)
        walk_args = (kd.rows, kd.top, kd.boxes, kd.nodes, kd.scale)
        subset = ((occ, occ.shape[0], None, None, 0.0)
                  if tables.occ_kd is None else
                  (tables.occ_kd.rows, tables.occ_kd.top,
                   tables.occ_kd.boxes, tables.occ_kd.nodes,
                   tables.occ_kd.scale))

        def k1(o=o, d=d):
            return dense.closest_lean_tree(o, d, *walk_args, 0.01)

        def k1_dense(o=o, d=d):
            return dense.closest_lean(o, d, rows, 0.01)

        def k4(o=o, d=d, lz1=lz1, lz2=lz2):
            return dense.closest_nee_lean_tree(o, d, lz1, lz2, *walk_args,
                                               *subset, light, 0.01)

        def k4_dense(o=o, d=d, lz1=lz1, lz2=lz2):
            return dense.closest_nee_lean(o, d, lz1, lz2, rows, occ, light,
                                          0.01)
        per_ray = {}

        def work(out, name, o=o, d=d, lz1=lz1, lz2=lz2):
            *w, tests, leaves = _lean_walk_work(o, d, lz1, lz2, light,
                                                tables, out)
            per_ray[name] = (tests, leaves)
            return w
        for name, walk, plain, body, compare, dense_work in (
                ("closest_lean_tree", k1,
                 lambda o=o, d=d: dense._closest_plain(o, d, rows, 0.01),
                 k1_dense, _compare_exact,
                 lambda o=o: _dense_work(o, rows, 8)),
                ("closest_nee_lean_tree", k4,
                 lambda o=o, d=d, lz1=lz1, lz2=lz2: dense._closest_nee_plain(
                     o, d, lz1, lz2, rows, occ, light, 0.01),
                 k4_dense, _compare_fused,
                 lambda o=o, d=d, lz1=lz1, lz2=lz2: _fused_work(
                     o, d, lz1, lz2, light, rows, occ, k4_dense(), 9))):
            torch.cuda.synchronize()
            _check_kernel(records, name, walk, plain, kd.rows.shape[0],
                          compare, functools.partial(work, name=name),
                          reps=10, plain_reps=2,
                          label=f"{name} ({box} box, {N_RAYS} rays, one in "
                          f"{PARK_EVERY} parked)")
            rec = records[name][-1]
            rec.update(box=box, dense_rows=rows.shape[0],
                       occ_rows=(occ.shape[0] if tables.occ_kd is None
                                 else tables.occ_kd.rows.shape[0]),
                       dense_bound_ms=_bound(*dense_work())["bound_ms"],
                       top_rows=kd.top, clusters=kd.boxes.shape[0],
                       node_tests_per_ray=per_ray[name][0],
                       clusters_per_ray=per_ray[name][1])
            sub = (f"its {occ.shape[0]} rows swept" if tables.occ_kd is None
                   else f"a copy of {tables.occ_kd.boxes.shape[0]} clusters")
            say("kernels", f"{name} on the {box} box: {kd.top} top rows and "
                f"{kd.boxes.shape[0]} clusters (the subset: {sub}); a live "
                f"ray at its final bounds tests "
                f"{per_ray[name][0]:.2f} nodes and sweeps "
                f"{per_ray[name][1]:.2f} clusters; bound "
                f"{rec['bound_ms']:.4f} ms against the dense count's "
                f"{rec['dense_bound_ms']:.4f}")
            _walk_against_dense(records, name, f"{name} ({box} box)",
                                walk, body, width)
        if tables.occ_kd is not None:
            so, sd, st = shadow
            okd = tables.occ_kd
            _walk_against_dense(
                records, "occluded_tree", f"occluded_tree ({box} box)",
                lambda: dense.occluded_tree(so, sd, st, okd.rows, okd.top,
                                            okd.boxes, okd.nodes, okd.scale,
                                            0.01),
                lambda: dense.occluded(so, sd, st, occ, 0.01), width)
        # Rays aimed at shared edges: ties that the lowest dense row wins.
        n_edge = N_RAYS // 4
        eo, ed = _edge_rays(scene, n_edge, 17, device)
        elz1, elz2 = _light_samples(n_edge, 17, device)
        t_all, _, _ = dense._pe_block(eo[:16384], ed[:16384], rows, 0.01)
        best = t_all.min(1).values
        ties = int((((t_all == best[:, None]).sum(1) > 1)
                    & (best < 1e15)).sum())
        if ties < best.shape[0] // 200:
            raise AssertionError(f"{box} edge rays: only {ties} of "
                                 f"{best.shape[0]} tie")
        for name, walk, others in (
                ("closest_lean_tree", k1(eo, ed),
                 (("plain", dense._closest_plain(eo, ed, rows, 0.01)),
                  ("dense body", k1_dense(eo, ed)))),
                ("closest_nee_lean_tree", k4(eo, ed, elz1, elz2),
                 (("plain", dense._closest_nee_plain(eo, ed, elz1, elz2, rows,
                                                     occ, light, 0.01)),
                  ("dense body", k4_dense(eo, ed, elz1, elz2))))):
            for what, other in others:
                torch.cuda.synchronize()
                compare = (_compare_exact if what == "dense body"
                           else _compare_fused if len(walk) == 3
                           else _compare_exact)
                err, extra = compare(name, walk, other)
                say("kernels", f"{name} ({box} box): {n_edge} rays aimed at "
                    f"shared edges ({ties} of the first {best.shape[0]} tie "
                    f"on t), walk against the {what}: max|err| {err} "
                    f"({extra})")
            records[name].append(dict(rows=kd.rows.shape[0], rays=n_edge,
                                      max_abs_err=0.0))


def _edge_rays(scene, n: int, seed: int, device):
    """n rays aimed at points of edges that two triangles share, half from
    the Cornell camera's eye, half from random points in the box: rays
    whose closest hit two rows share at equal t."""
    import numpy as np
    import torch
    v0 = scene.tri_v0[:scene.num_tris].cpu().numpy()
    corners = [v0, v0 + scene.tri_e1[:scene.num_tris].cpu().numpy(),
               v0 + scene.tri_e2[:scene.num_tris].cpu().numpy()]
    owners = {}
    for i in range(scene.num_tris):
        pts = [tuple(c[i]) for c in corners]
        for a, b in ((0, 1), (1, 2), (2, 0)):
            owners.setdefault(tuple(sorted((pts[a], pts[b]))), []).append(i)
    shared = np.array([k for k, v in owners.items() if len(v) == 2],
                      np.float32)
    r = np.random.default_rng(seed)
    pick = shared[r.integers(0, len(shared), n)]
    w = r.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    target = pick[:, 0] + (pick[:, 1] - pick[:, 0]) * w
    o = np.broadcast_to(np.array([278.0, 273.0, -800.0], np.float32),
                        (n, 3)).copy()
    o[n // 2:] = r.uniform([0, 0, 0], [556, 548, 559], (n - n // 2, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)
    return t(o), t(d)


def _walk_against_dense(records, name, label, walk, body, width: str):
    """A walk of K1-K4 (``walk()``) against its dense body (``body()``,
    DENSE_BODY) on the same inputs, bit for bit, and both timed in
    interleaved pairs (walk, body, body, walk); both times go on the
    walk's first record, under ``pair_ms_<width>`` and
    ``dense_pair_ms_<width>``."""
    import torch
    a, b = walk(), body()
    torch.cuda.synchronize()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: the walk differs from "
                             f"{DENSE_BODY[name]}")
    w0, y0, y1, w1 = (gpu_ms(fn, 10) for fn in (walk, body, body, walk))
    pair = ((w0 + w1) / 2, (y0 + y1) / 2)
    records[name][0][f"pair_ms_{width}"] = pair[0]
    records[name][0][f"dense_pair_ms_{width}"] = pair[1]
    say("kernels", f"{label}, {width} ({a[0].shape[0]} rays): the walk "
        f"bitwise equal to {DENSE_BODY[name]}; interleaved, walk "
        f"{pair[0]:.4f} ms ({w0:.4f}, {w1:.4f}), dense body {pair[1]:.4f} "
        f"ms ({y0:.4f}, {y1:.4f}), {pair[1] / pair[0]:.2f}x")


def phase_fused_kernels(device, records):
    """K4 on the mixed box and K5 on the sphere box at N_RAYS rays (camera
    rays and bounce rays, one lane in PARK_EVERY parked, light samples from
    the counter RNG) against their plain versions, timed; bound from
    _dense_work / _dense_occluded_work (K5: its walk's own work,
    _fused_walk_work, the dense count beside it). K5's walk also on rays
    aimed at shared edges, where rows tie."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, dense
    for name, scene_file, seed, full in (
            ("closest_nee_lean", "cornell_box_mixed.obj", 11, False),
            ("closest_nee_full", "cornell_box_sphere.obj", 12, True)):
        scene = tp.load_scene(str(ASSETS / scene_file), device=device)
        tables, light = dense.prepare(scene), dense.light_vector(scene)
        rows = tables.rows
        occ = rows if full else tables.occ_rows
        if (rows.shape[0] <= dense.LEAN_MAX_TRIS) == full:
            raise AssertionError(f"{scene_file}: {rows.shape[0]} rows do not "
                                 f"take {name}")
        o, d, shadow = _phase3_rays(
            scene, device, seed, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), N_RAYS)
        (o, d), _ = _park((o, d), shadow, PARK_EVERY)
        lz1, lz2 = _light_samples(N_RAYS, seed, device)

        def plain(o=o, d=d, lz1=lz1, lz2=lz2):
            return dense._closest_nee_plain(o, d, lz1, lz2, rows, occ, light,
                                            0.01, *((1e16, True) if full
                                                    else ()))
        if not full:
            _check_kernel(records, name, lambda: dense.closest_nee_lean(
                o, d, lz1, lz2, rows, occ, light, 0.01), plain,
                rows.shape[0], _compare_fused,
                lambda out: _fused_work(o, d, lz1, lz2, light, rows, occ,
                                        out, 9),
                reps=10, plain_reps=2)
            records[name][-1]["occ_rows"] = occ.shape[0]
            continue
        kd = tables.kd

        def walk(o=o, d=d, lz1=lz1, lz2=lz2):
            return dense.closest_nee_full(o, d, lz1, lz2, kd.rows, kd.top,
                                          kd.boxes, kd.nodes, kd.scale,
                                          light, 0.01, 1e16)

        counts = {}

        def walk_work(out):
            *work, tests, leaves, live = _fused_walk_work(
                o, d, lz1, lz2, light, kd, out, 25)
            counts.update(tests=tests / live, leaves=leaves / live)
            return work
        torch.cuda.synchronize()
        _check_kernel(records, name, walk, plain, kd.rows.shape[0],
                      _compare_fused, walk_work, reps=10, plain_reps=2)
        dense_bound = _bound(*_fused_work(o, d, lz1, lz2, light, rows, occ,
                                          plain(), 25))["bound_ms"]
        rec = records[name][-1]
        rec.update(occ_rows=kd.rows.shape[0], dense_bound_ms=dense_bound,
                   top_rows=kd.top, clusters=kd.boxes.shape[0],
                   node_tests_per_ray=counts["tests"],
                   clusters_per_ray=counts["leaves"])
        say("kernels", f"{name}: the kd copy, {kd.top} top rows and "
            f"{kd.boxes.shape[0]} clusters of "
            f"{(kd.rows.shape[0] - kd.top) // kd.boxes.shape[0]} rows "
            f"({clustered.tree_depth(kd.boxes.shape[0])} levels); a live ray "
            f"of the walk at its final bounds: {counts['tests']:.2f} node "
            f"tests, {counts['leaves']:.2f} clusters swept (closest and "
            f"shadow); bound {rec['bound_ms']:.4f} ms against the dense "
            f"count's {dense_bound:.4f}")
        # Rays aimed at shared edges: ties that the lowest dense row wins.
        eo, ed = _edge_rays(scene, N_RAYS // 4, 13, device)
        elz1, elz2 = _light_samples(N_RAYS // 4, 13, device)
        t_all, _, _ = dense._pe_block(eo[:16384], ed[:16384], rows, 0.01)
        best = t_all.min(1).values
        ties = int((((t_all == best[:, None]).sum(1) > 1)
                    & (best < 1e15)).sum())
        if ties < best.shape[0] // 200:
            raise AssertionError(f"K5 edge rays: only {ties} of "
                                 f"{best.shape[0]} tie")
        out_w = walk(eo, ed, elz1, elz2)
        # K6's compare (ties to the lowest kd row) would answer another
        # dense row than the plain version on some of these rays.
        tk, rk = dense._closest_plain(eo, ed, kd.rows, 0.01)
        by_kd_row = torch.where(tk < 1e15, kd.rows[rk.long(), 15], 0.0)
        out_p = plain(eo, ed, elz1, elz2)
        wrong = int((by_kd_row.to(torch.int32) != out_p[1]).sum())
        torch.cuda.synchronize()
        err, extra = _compare_exact(name, out_w, out_p)
        say("kernels", f"{name}: {N_RAYS // 4} rays aimed at shared edges "
            f"({ties} of the first {best.shape[0]} tie on t; a fold on the "
            f"kd row would answer another row on {wrong}), walk against the "
            f"plain version: max|err| {err} ({extra})")
        records[name].append(dict(rows=kd.rows.shape[0], rays=N_RAYS // 4,
                                  max_abs_err=0.0))
    _check_lean_walks(records, device)


def phase_fused_goldens(device):
    """The direct-lighting golden modes under ``fused_nee``: K4's walk
    renders them (and K1 / K2 / K4's dense body never), RMSE < 0.01
    against tests/goldens/."""
    import numpy as np
    import tpu_pt_torch as tp
    from tpu_pt_torch import film
    scene = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    for name, overrides in GOLDEN_MODES:
        if not overrides.get("use_direct_lighting"):
            continue
        kw = {**dict(width=128, height=128, spp=32, max_depth=4), **overrides}
        _zero_counters()
        accum, u8, per = _render(scene, device, [0], fused_nee=True, **kw)
        counts = _read_counters()
        _check_frame(name, accum, per)
        if counts["closest_nee_lean_tree"] <= 0 or any(
                counts[k] for k in ("closest_lean", "closest_lean_tree",
                                    "occluded", "closest_nee_lean")):
            raise AssertionError(f"{name} under fused_nee: launches {counts}")
        golden = film.read_png(str(GOLDENS / f"{name}.png"))
        err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                        golden.astype(np.float32) / 255.0)
        say("goldens", f"{name} under fused_nee: RMSE {err:.5f} "
            f"({per[0][0] * 1e3:.1f} ms, K4's walk x "
            f"{counts['closest_nee_lean_tree']})")
        if not err < GOLDEN_RMSE:
            raise AssertionError(f"{name} fused: RMSE {err} >= {GOLDEN_RMSE}")


def _u8_rmse(a, b) -> float:
    from tpu_pt_torch import film
    return film.rmse(film.make_color(a).cpu().numpy() / 255.0,
                     film.make_color(b).cpu().numpy() / 255.0)


def phase_fused_main(device, smi, twins, records):
    """Each run of FUSED_TWINS under ``fused_nee`` and bench.py's frame on
    the ``regen`` scheduler, counters zeroed just before each run and read
    just after; frame time, Mrays/s and the sRGB RMSE against the unfused
    pixelq twin of phase 6 (``twins``: tag -> (run, accum, s/frame, Mrays/s)).
    The fused kernel must launch once per round and the kernels it
    replaces never. The warm-up frames record one call of each fused
    kernel, then held bitwise against its plain version and (K4's walk)
    against its dense body, timed in pairs. Returns the launches summed
    per kernel."""
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import dense
    launches = dict.fromkeys(KERNELS, 0)
    fused_walks = ("closest_nee_lean_tree", "closest_nee_full")
    tap = _Tap(fused_walks)
    runs = [(tag, dict(fused_nee=True), fused, banned)
            for tag, fused, banned in FUSED_TWINS]
    runs.append((REGEN_OF, dict(scheduler="regen"), "closest_lean_tree", ()))
    scenes = {}
    for tag, extra, once, banned in runs:
        (_, scene_file, frames, timed, kw, _), base, base_s, base_mr = \
            twins[tag]
        if scene_file not in scenes:
            scenes[scene_file] = tp.load_scene(str(ASSETS / scene_file),
                                               device=device)
        _zero_counters()
        accum, _, per = _render(scenes[scene_file], device, frames,
                                tap=tap if "fused_nee" in extra else None,
                                use_direct_lighting=True,
                                use_importance_sampling=True, **kw, **extra)
        counts = _read_counters()
        what = "fused_nee" if "fused_nee" in extra else "regen"
        _check_frame(f"{tag} {what}", accum, per)
        rounds = sum(int(p[2].wavefront_iterations) for p in per)
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        err = _u8_rmse(accum, base)
        say("main", f"{tag}, {what}: {sec / timed * 1e3:.1f} ms/frame, "
            f"{rays / sec / 1e6:.3f} Mrays/s (pixelq unfused "
            f"{base_s * 1e3:.1f} ms/frame, {base_mr:.3f} Mrays/s); "
            f"{rays // timed} rays/frame, {rounds} rounds in "
            f"{len(frames)} frames; launches "
            f"{ {k: n for k, n in counts.items() if n} }; sRGB RMSE against "
            f"the pixelq unfused frame {err:.6f}; {smi}")
        if counts[once] != rounds:
            raise AssertionError(f"{tag} {what}: {once} launched "
                                 f"{counts[once]} times in {rounds} rounds")
        for k in banned:
            if counts[k]:
                raise AssertionError(f"{tag} {what}: {k} launched")
        if not err < TWIN_RMSE:
            raise AssertionError(f"{tag} {what}: RMSE {err} >= {TWIN_RMSE}")
        for k, n in counts.items():
            launches[k] += n
    _hold_recorded(records, tap.picked, "fused main-path")
    for name in fused_walks:
        if not any(k[0] == name for k in tap.picked):
            raise AssertionError(f"no {name} call was recorded")
    # K4's recorded call against its dense body on the mixed box's dense
    # table, bit for bit, both timed in interleaved pairs.
    mixed = dense.prepare(scenes["cornell_box_mixed.obj"])
    for (name, _), (args, _) in tap.picked.items():
        if name == "closest_nee_lean_tree":
            _walk_against_dense(
                records, name, "K4 (a bench-frame fused_nee call)",
                lambda args=args: dense.closest_nee_lean_tree(*args),
                functools.partial(_dense_body_of, name, args, mixed),
                "recorded")
    return launches


def _run(cmd, what: str, env=None, timeout=600):
    """Run a command from the repository root; raise with its output if it
    fails. Returns its standard output."""
    import os
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, **(env or {})})
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def phase_entry_points(device, smi):
    """The user's entry points on the card: the CLI (a checkpointed render
    resumed bitwise, the Whitted route with --validate), the bench module,
    and trace_pixel under fused_nee."""
    import numpy as np
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch import debug, film
    from tpu_pt_torch.intersect import dense
    from tpu_pt_torch.render import CameraArrays, render_wavefront
    out = REPO / "build" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    cli = [sys.executable, "-m", "tpu_pt_torch.cli", "render"]
    mixed = str(ASSETS / "cornell_box_mixed.obj")
    t0 = time.perf_counter()
    _run(cli + [mixed, "-o", str(out / "two.png"), "--frames", "2",
                "--checkpoint", str(out / "two.npz"), *CLI_RENDER],
         "cli render --checkpoint")
    resumed = _run(cli + [mixed, "-o", str(out / "resumed.exr"), "--frames",
                          "2", "--resume", str(out / "two.npz"),
                          "--checkpoint", str(out / "resumed.npz"),
                          "--stats"], "cli render --resume")
    _run(cli + [mixed, "-o", str(out / "four.ppm"), "--frames", "4",
                "--checkpoint", str(out / "four.npz"), *CLI_RENDER],
         "cli render, four frames")
    with np.load(out / "resumed.npz") as a, np.load(out / "four.npz") as b:
        same = np.array_equal(a["accum"], b["accum"])
        frames = (int(a["frame_idx"]), int(b["frame_idx"]))
    say("entry", f"cli render 128^2 x 8 spp: 2 frames + --resume 2 against "
        f"4 straight: accumulators bitwise equal {same}, frames {frames} "
        f"({time.perf_counter() - t0:.1f} s for 3 CLI runs); "
        + resumed.strip().splitlines()[0].split("\r")[-1].strip())
    if not same or frames != (4, 4):
        raise AssertionError("the resumed CLI render differs from four "
                             "straight frames")
    if film.read_ppm(str(out / "four.ppm")).shape != (128, 128, 3):
        raise AssertionError("cli: bad PPM output")
    if not np.isfinite(film.read_exr(str(out / "resumed.exr"))).all():
        raise AssertionError("cli: non-finite EXR output")

    t0 = time.perf_counter()
    text = _run(cli + [str(ASSETS / "pbr_test.gltf"), "-o",
                       str(out / "whitted.png"), "--frames", "1",
                       *CLI_WHITTED], "cli render --validate (Whitted)")
    say("entry", f"cli render pbr_test.gltf {CLI_WHITTED}: ok in "
        f"{time.perf_counter() - t0:.1f} s; "
        + text.strip().splitlines()[0].split("\r")[-1].strip())

    line = _run([sys.executable, "-m", "tpu_pt_torch.bench"], "bench",
                env=BENCH_SHORT).strip().splitlines()[-1]
    result = json.loads(line)
    missing = {"metric", "value", "unit", "ms_per_frame", "rays_per_frame",
               "device"} - set(result)
    if missing or not result["value"] > 0:
        raise AssertionError(f"bench line lacks {missing}: {line}")
    say("entry", f"python -m tpu_pt_torch.bench {BENCH_SHORT}: {line}")

    scene = tp.load_scene(mixed, device=device)
    cfg = tp.RenderConfig(**TRACE)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    radiance, _ = render_wavefront(scene, cam, cfg, 0,
                                   cfg.width * cfg.height, 0)
    worst, depths = 0.0, []
    for x, y in ((16, 16), (5, 27), (26, 6), (12, 3)):
        before = dict(dense.LAUNCHES)
        records = debug.trace_pixel(scene, cam, cfg, x, y)
        fused = (dense.LAUNCHES["closest_nee_lean_tree"]
                 - before["closest_nee_lean_tree"])
        if fused != len(records) or any(
                dense.LAUNCHES[k] != before[k]
                for k in ("closest_lean", "closest_lean_tree",
                          "closest_nee_lean")):
            raise AssertionError("trace_pixel did not go through K4's walk")
        total = torch.tensor([r["contrib"] for r in records]).sum(0)
        want = radiance[y * cfg.width + x].cpu()
        worst = max(worst, float((total - want).abs().max()))
        depths.append(len(records))
        if not torch.allclose(total, want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"trace_pixel({x}, {y}) sums to {total}, "
                                 f"the frame has {want}")
    say("entry", f"trace_pixel under fused_nee ({cfg.width}^2 x 1 spp): four "
        f"pixels, {depths} bounces, contributions sum to the frame's pixel, "
        f"max |diff| {worst:.3e}")


def _progressive(step, cam, accum, frames):
    """``frames`` steps of ``step(cam, frame, accum)``; per frame (a copy
    of the accumulator, seconds, stats)."""
    import torch
    out = []
    for f in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accum, _, stats = step(cam, f, accum)
        torch.cuda.synchronize()
        out.append((accum.clone(), time.perf_counter() - t0, stats))
    return out


def _same_counts(tag, a, b):
    for k in ("rays_traced", "shadow_rays", "done_histogram"):
        if not bool((getattr(a, k) == getattr(b, k)).all()):
            raise AssertionError(f"{tag}: {k} {getattr(a, k)} against "
                                 f"{getattr(b, k)}")


def phase_multi_gpu(device, smi):
    """A one-rank NCCL world through tpu_pt_torch.dist: bench.py's frame
    and the forest through the sharded step against the single-device
    entry points, tools/bench_dist_torch.py's 4K frame, and the time of
    the 4K radiance's all_reduce. Returns the launches summed per kernel
    over the sharded runs (counters zeroed before each, read after)."""
    import socket
    import torch
    import torch.distributed as tdist
    import tpu_pt_torch as tp
    from tpu_pt_torch import dist
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_multihost(f"127.0.0.1:{port}", 1, 0)
    mesh = dist.device_mesh()
    if tuple(mesh.shape) != (1, 1) or tdist.get_backend() != "nccl":
        raise AssertionError(f"a one-rank {tdist.get_backend()} world gave "
                             f"a {tuple(mesh.shape)} mesh")
    say("multi-gpu", f"{tdist.get_backend()} world of "
        f"{tdist.get_world_size()}, mesh {tuple(mesh.shape)} (tile, spp), "
        f"NCCL {torch.cuda.nccl.version()}")
    launches = dict.fromkeys(KERNELS, 0)

    # bench.py's frame: two render_frame runs, then the sharded step.
    _, scene_file, _, _, kw, _ = next(r for r in MAIN_RUNS
                                      if r[0] == BENCH_TAG)
    scene = tp.load_scene(str(ASSETS / scene_file), device=device)
    cfg = tp.RenderConfig(use_direct_lighting=True,
                          use_importance_sampling=True, **kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    plain = [_progressive(
        lambda c, f, a: render_frame(scene, c, cfg, f, a), cam,
        init_accum(cfg, device=device), 2) for _ in range(2)]
    _zero_counters()
    sharded = _progressive(dist.make_sharded_renderer(scene, cfg, mesh), cam,
                           dist.init_accum_sharded(cfg, mesh), 2)
    counts = _read_counters()
    rounds = sum(int(st.wavefront_iterations) for _, _, st in sharded)
    for k in ("closest_lean_tree", "occluded"):
        if counts[k] != rounds:
            raise AssertionError(f"sharded {BENCH_TAG}: {k} launched "
                                 f"{counts[k]} times in {rounds} rounds")
    for k in _LEAN_BANNED:
        if counts[k]:
            raise AssertionError(f"sharded {BENCH_TAG}: {k} launched")
    for k, n in counts.items():
        launches[k] += n
    for (a, _, sa), (b, _, sb), (c, _, sc) in zip(*plain, sharded):
        _same_counts(f"sharded {BENCH_TAG}", sc, sa)
        _same_counts(f"{BENCH_TAG}, a second run", sb, sa)
    repeat = [int((a != b).any(-1).sum())
              for (a, _, _), (b, _, _) in zip(*plain)]
    worst = max(float((c - a).abs().max())
                for (a, _, _), (c, _, _) in zip(plain[0], sharded))
    if not any(repeat):
        held = "bitwise"
        bad = [int((c != a).any(-1).sum())
               for (a, _, _), (c, _, _) in zip(plain[0], sharded)]
        if any(bad):
            raise AssertionError(f"sharded {BENCH_TAG}: {bad} pixels differ "
                                 "from render_frame's, which repeats "
                                 "bitwise")
    else:
        held = (f"within {DIST_TOL} (two render_frame runs differ in "
                f"{repeat} pixels: pixelq's index_add_ is atomic on the "
                "card)")
        for (a, _, _), (c, _, _) in zip(plain[0], sharded):
            if not torch.allclose(c, a, rtol=DIST_TOL, atol=DIST_TOL):
                raise AssertionError(f"sharded {BENCH_TAG}: max |diff| "
                                     f"{worst} against render_frame")
    say("multi-gpu", f"{BENCH_TAG} through the sharded step, frames 0-1: "
        f"accumulators {held} against render_frame (max |diff| "
        f"{worst:.3e}), counts equal; frame 1 "
        f"{sharded[1][1] * 1e3:.1f} ms sharded, "
        f"{plain[0][1][1] * 1e3:.1f} / {plain[1][1][1] * 1e3:.1f} ms "
        f"render_frame; {rounds} rounds, launches "
        f"{ {k: n for k, n in counts.items() if n} }; {smi}")

    # The forest (instanced: K9 / K10) through the sharded step.
    ws = tp.load_gltf(str(ASSETS / FOREST), instancing="auto", device=device)
    wcam = _whitted_camera(WHITTED_VIEW, device)
    wcfg = tp.RenderConfig(**DIST_FOREST)
    (ref, _, ref_stats), = _progressive(
        lambda c, f, a: tp.render_whitted_frame(ws, c, wcfg, f, a), wcam,
        init_accum(wcfg, device=device), 1)
    _zero_counters()
    (out, sec, stats), = _progressive(
        dist.make_sharded_renderer(ws, wcfg, mesh), wcam,
        dist.init_accum_sharded(wcfg, mesh), 1)
    counts = _read_counters()
    for k in ("closest_inst", "occluded_inst"):
        if counts[k] <= 0:
            raise AssertionError(f"sharded forest: {k} never launched")
    for k, n in counts.items():
        launches[k] += n
    _same_counts("sharded forest", stats, ref_stats)
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=DIST_TOL, atol=DIST_TOL):
        raise AssertionError(f"sharded forest: max |diff| {err}")
    say("multi-gpu", f"forest {DIST_FOREST['width']}^2 x "
        f"{DIST_FOREST['spp']} spp through the sharded step: within "
        f"{DIST_TOL} of render_whitted_frame (max |diff| {err:.3e}), counts "
        f"equal, {sec * 1e3:.1f} ms; launches "
        f"{ {k: n for k, n in counts.items() if n} }")

    # tools/bench_dist_torch.py's 4K frame in this world.
    _zero_counters()
    payload = _tool("bench_dist_torch").run(smi)
    counts = _read_counters()
    for k in ("closest_lean_tree", "occluded"):
        if counts[k] <= 0:
            raise AssertionError(f"bench_dist_torch: {k} never launched")
    if not payload["value"] > 0 or payload["mesh"] != [1, 1]:
        raise AssertionError(f"bench_dist_torch: {payload}")
    for k, n in counts.items():
        launches[k] += n
    say("multi-gpu", f"tools/bench_dist_torch.py: {json.dumps(payload)}")

    # The spp group's all_reduce of the 4K radiance.
    rad = torch.rand(DIST_RADIANCE, device=device)
    group = mesh.get_group("spp")
    ms = gpu_ms(lambda: tdist.all_reduce(rad, group=group), 20)
    nbytes = rad.numel() * rad.element_size()
    say("multi-gpu", f"all_reduce of the 4K radiance {list(rad.shape)} f32 "
        f"({nbytes / 1e6:.1f} MB) over the spp group of one rank: "
        f"{ms:.4f} ms (CUDA events, mean of 20; read and write at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s: {2 * nbytes / PEAK_BYTES * 1e3:.4f} "
        f"ms); {smi}")
    tdist.destroy_process_group()
    say("multi-gpu", "kernel launches of the sharded runs: "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches


# --------------------------------------------------------------------------
# The native host library, the viewer and the convergence report
# --------------------------------------------------------------------------

def _primary_rays(device, side: int):
    """side^2 jittered camera rays of the Cornell camera."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch import rng
    from tpu_pt_torch.render import CameraArrays, camera_rays
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    pix = torch.arange(side * side, device=device)
    jx, jy = rng.uniform2(pix, 0, 0, rng.STREAM_JITTER)
    return camera_rays(cam, pix, side, side, jx, jy)


def _check_host_tree(label, bvh, n):
    """The leaves of a host-built tree cover every triangle once and its
    skip-link walk visits every node."""
    import numpy as np
    tri = bvh.tri.cpu().numpy()
    if not np.array_equal(np.sort(tri[tri >= 0]), np.arange(n)):
        raise AssertionError(f"{label}: the leaves do not cover every "
                             "triangle once")
    left, skip, leaf = (bvh.left.cpu().tolist(), bvh.skip.cpu().tolist(),
                        (tri >= 0).tolist())
    seen, cur, steps = bytearray(2 * n - 1), 0, 0
    while cur != -1 and steps < 4 * n:
        seen[cur] = 1
        cur = skip[cur] if leaf[cur] else left[cur]
        steps += 1
    if cur != -1 or sum(seen) != 2 * n - 1:
        raise AssertionError(f"{label}: the skip walk visits {sum(seen)} of "
                             f"{2 * n - 1} nodes")


def phase_native(device, smi, big):
    """The native host library: its OBJ parse against the Python one; the
    host LBVH of the big and the huge mesh (leaves, skip walk, times
    beside the device build; closest hits through it against the
    device-built tree on the big mesh); load_scene of the huge mesh with
    and without it; the PNG goldens through its unfilter against numpy."""
    import numpy as np
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch import film, native
    from tpu_pt_torch.intersect import lbvh
    from tpu_pt_torch.scene import objloader
    for path in NATIVE_OBJS:
        t0 = time.perf_counter()
        nat = objloader.load_obj(str(path), use_native=True)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = objloader._load_obj_python(str(path))
        t_py = time.perf_counter() - t0
        # Material numbers: the native parser reads f32 (tests/test_native
        # .py's 1e-6).
        close = functools.partial(np.allclose, rtol=1e-6, atol=0)
        if not (close(nat.vertices, py.vertices)
                and np.array_equal(nat.indices, py.indices)
                and np.array_equal(nat.mat_indices, py.mat_indices)
                and [(m.name, m.bsdf) for m in nat.materials]
                == [(m.name, m.bsdf) for m in py.materials]
                and all(close([a.diffuse, a.emission, (a.ior, a.roughness,
                                                       a.metallic)],
                              [b.diffuse, b.emission, (b.ior, b.roughness,
                                                       b.metallic)])
                        for a, b in zip(nat.materials, py.materials))):
            raise AssertionError(f"{path.name}: the native and Python "
                                 "parses differ")
        say("native", f"{path.name}: {nat.indices.shape[0]} triangles, "
            f"native parse {t_nat * 1e3:.1f} ms, Python {t_py * 1e3:.1f} ms "
            f"({t_py / t_nat:.1f}x), equal (vertices to 1e-6)")

    # load_scene of the huge mesh with the native parse and without it
    # (TPU_PT_NO_NATIVE=1: Python parse); both attach the native LBVH.
    spent = {}
    fns = {n: getattr(m, n) for m, n in ((objloader, "load_obj"),
                                         (lbvh, "build_lbvh_host"))}

    def timed(module, name):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fns[name](*a, **kw)
            spent[name] = time.perf_counter() - t
            return out
        setattr(module, name, call)
    loads = {}
    try:
        timed(objloader, "load_obj")
        timed(lbvh, "build_lbvh_host")
        for what, variables in (("auto", {}),
                                ("TPU_PT_NO_NATIVE=1",
                                 dict(TPU_PT_NO_NATIVE="1"))):
            with _env(**variables):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                huge = tp.load_scene(str(BUILD_ASSETS / HUGE_MESH),
                                     device=device)
                torch.cuda.synchronize()
                loads[what] = (time.perf_counter() - t0, dict(spent))
    finally:
        objloader.load_obj = fns["load_obj"]
        lbvh.build_lbvh_host = fns["build_lbvh_host"]
    say("native", f"load_scene {HUGE_MESH}: " + "; ".join(
        f"{what} {sec:.2f} s (parse {t['load_obj']:.2f} s, native LBVH "
        f"{t['build_lbvh_host']:.2f} s)" for what, (sec, t) in loads.items()))

    for label, scene in (("big mesh", big), ("huge mesh", huge)):
        n = scene.num_tris_padded
        _check_host_tree(label, scene.bvh, n)
        host = {k: t.cpu().numpy() for k, t in (
            ("v0", scene.tri_v0), ("e1", scene.tri_e1),
            ("e2", scene.tri_e2), ("normal", scene.tri_normal),
            ("valid", scene.tri_valid), ("mat_id", scene.mat_id),
            ("mat_bsdf", scene.mat_bsdf))}
        t0 = time.perf_counter()
        again = lbvh.build_lbvh_host(scene, host=host)
        host_s = time.perf_counter() - t0
        if not torch.equal(again.nodes, scene.bvh.nodes):
            raise AssertionError(f"{label}: the native build does not repeat")
        dev_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev_bvh = lbvh.build_lbvh(scene)
            torch.cuda.synchronize()
            dev_s.append(time.perf_counter() - t0)
        line = (f"{label} ({n} padded triangles, {2 * n - 1} nodes): leaves "
                f"cover every triangle once, the skip walk visits every "
                f"node; native build on the host {host_s * 1e3:.1f} ms (its "
                f"arrays given), device build {dev_s[0] * 1e3:.1f} ms first, "
                f"{dev_s[1] * 1e3:.1f} ms again")
        if scene is big:
            o, d = _primary_rays(device, LBVH_CHECK["width"])
            hn = lbvh.intersect_closest(big, o, d)
            hd = lbvh.intersect_closest(big, o, d, bvh=dev_bvh)
            hit_same = float((hn.hit == hd.hit).float().mean())
            both = hn.hit & hd.hit
            id_same = float((hn.tri == hd.tri)[both].float().mean())
            dt = float((hn.t - hd.t)[both].abs().max())
            line += (f"; {LBVH_CHECK['width']}^2 primary rays through the "
                     f"native and the device tree: hit / miss agree on "
                     f"{hit_same:.4f}, ids on {id_same:.4f} of "
                     f"{int(both.sum())} hits, max |dt| {dt:.3e}")
            if hit_same < ROW_AGREE or id_same < ROW_AGREE or dt > 1e-2:
                raise AssertionError("the native and device trees' walks "
                                     "disagree")
        say("native", f"{line}; {smi}")
    del huge

    # The PNG goldens through the native unfilter and through numpy.
    scan = native.unfilter_png_native
    calls = []
    times = {}
    try:
        native.unfilter_png_native = lambda *a: calls.append(1) or scan(*a)
        pngs = sorted(GOLDENS.glob("*.png"))
        t0 = time.perf_counter()
        nat = [film.read_png(str(p)) for p in pngs]
        times["native"] = time.perf_counter() - t0
        available = native.available
        native.available = lambda: False
        try:
            t0 = time.perf_counter()
            py = [film.read_png(str(p)) for p in pngs]
            times["numpy"] = time.perf_counter() - t0
        finally:
            native.available = available
    finally:
        native.unfilter_png_native = scan
    if len(calls) != len(pngs) or not all(
            np.array_equal(a, b) for a, b in zip(nat, py)):
        raise AssertionError(f"PNG goldens: {len(calls)} native unfilters "
                             f"of {len(pngs)}, or the images differ")
    say("native", f"{len(pngs)} PNG goldens read through the native unfilter "
        f"({times['native'] * 1e3:.1f} ms) and numpy's "
        f"({times['numpy'] * 1e3:.1f} ms): equal")


@contextlib.contextmanager
def _no_tty():
    """Standard input from /dev/null: the viewer runs headless."""
    import os
    saved = sys.stdin
    with open(os.devnull) as null:
        sys.stdin = null
        try:
            yield
        finally:
            sys.stdin = saved


def phase_viewer(device, smi):
    """``cli view`` headless (VIEW_RUNS), in this process so that the
    launch counters see it, each PNG bitwise against the same frames of
    ``render_frame`` / ``render_whitted_frame``; the 512^2 draw times;
    ``HttpDisplay`` on a free port, its frame fetched over loopback.
    Returns the launches summed per kernel over the viewer runs."""
    import io
    import urllib.request
    import numpy as np
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch import cli, film, viewer
    from tpu_pt_torch.render import CameraArrays, init_accum
    out = REPO / "build" / "viewer"
    out.mkdir(parents=True, exist_ok=True)
    launches = dict.fromkeys(KERNELS, 0)
    frames_of = {}
    for label, scene_file, frames, flags, expect in VIEW_RUNS:
        png = out / f"{label.replace(' ', '_')}.png"
        buf = io.StringIO()
        _zero_counters()
        t0 = time.perf_counter()
        with _no_tty(), contextlib.redirect_stdout(buf):
            rc = cli.main(["view", str(ASSETS / scene_file), "-o", str(png),
                           "--frames", str(frames), "--device", str(device),
                           *flags])
        wall = time.perf_counter() - t0
        counts = _read_counters()
        status = buf.getvalue().split("\x1b[K")[-1].strip()
        if rc != 0 or not status.startswith(f"frame {frames} |"):
            raise AssertionError(f"view {label}: rc {rc}, status {status!r}")
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"view {label}: {k} never launched")
        for k, n in counts.items():
            launches[k] += n

        # The same frames through the plain entry point.
        size = {k: int(flags[flags.index(f"--{k}") + 1])
                for k in ("width", "height", "spp", "depth")}
        cfg = tp.RenderConfig(
            width=size["width"], height=size["height"], spp=size["spp"],
            max_depth=size["depth"],
            use_direct_lighting="--direct-lighting" in flags,
            use_importance_sampling="--importance-sampling" in flags)
        if scene_file.endswith(".gltf"):
            scene = tp.load_gltf(str(ASSETS / scene_file), device=device)
            camera, _ = viewer.gltf_view(scene,
                                         size["width"] / size["height"])
            step = tp.render_whitted_frame
        else:
            scene = tp.load_scene(str(ASSETS / scene_file), device=device)
            camera = tp.cornell_default_camera(
                aspect=size["width"] / size["height"])
            step = tp.render_frame
        cam = CameraArrays.from_camera(camera, device=device)

        def plain():
            accum = init_accum(cfg, device=device)
            times = []
            for f in range(frames):
                torch.cuda.synchronize()
                t = time.perf_counter()
                accum, u8, _ = step(scene, cam, cfg, f, accum)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            return tp.image_to_host(u8), times
        want, times = plain()
        got = film.read_png(str(png))
        held = "bitwise equal"
        if not np.array_equal(got, want):
            again, _ = plain()
            off = np.abs(got.astype(int) - want.astype(int)).max(-1)
            if np.array_equal(again, want) or off.max() > 1 or (
                    off > 0).mean() > 0.01:
                raise AssertionError(f"view {label}: the PNG differs from "
                                     f"the plain frames on {(off > 0).sum()} "
                                     "pixels")
            held = (f"within one level on {(off > 0).sum()} pixels (two "
                    "plain runs differ too)")
        frames_of[label] = (want, status)
        say("viewer", f"view {label} ({' '.join(flags)}, --frames {frames}, "
            f"headless): {wall:.2f} s in all; last status: {status}; the "
            f"plain entry point {', '.join(f'{t * 1e3:.1f}' for t in times)} "
            f"ms/frame; PNG {held}; launches "
            f"{ {k: n for k, n in counts.items() if n} }; {smi}")

    # Draw costs of one 512^2 frame, and the HTTP presenter over loopback.
    img, status = frames_of["mixed box"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        viewer.TerminalDisplay().draw(img, status)
        ansi_ms = (time.perf_counter() - t0) * 1e3
    display = viewer.HttpDisplay(0)
    try:
        t0 = time.perf_counter()
        display.draw(img, status)
        http_ms = (time.perf_counter() - t0) * 1e3
        base = f"http://127.0.0.1:{display.port}"
        with urllib.request.urlopen(base + "/frame.png", timeout=30) as r:
            (out / "http.png").write_bytes(r.read())
        with urllib.request.urlopen(base + "/status", timeout=30) as r:
            served = r.read().decode()
    finally:
        display.close()
    if not np.array_equal(film.read_png(str(out / "http.png")), img) or (
            served != status):
        raise AssertionError("HttpDisplay served another frame or status")
    say("viewer", f"draw of a {img.shape[1]}x{img.shape[0]} frame: ANSI {ansi_ms:.1f} ms, PNG for "
        f"HTTP {http_ms:.1f} ms; HttpDisplay on port {display.port}: "
        "/frame.png and /status over loopback equal to what was drawn")
    return launches


def phase_convergence(device, smi):
    """tools/convergence_torch.py's curves at CONVERGENCE (cut from its 64
    reference and 16 test frames); NEE's speed-up must hold. Returns the
    launches summed per kernel."""
    tool = _tool("convergence_torch")
    _zero_counters()
    t0 = time.perf_counter()
    records = tool.curves(device, **CONVERGENCE)
    sec = time.perf_counter() - t0
    counts = _read_counters()
    line = tool.summary(records)
    for r in records:
        say("convergence", json.dumps(r))
    say("convergence", f"{json.dumps(line)} ({CONVERGENCE}: the tool's "
        "full size and spp, its frames cut from 64 + 16 to fit this run; "
        f"{sec:.1f} s; launches "
        f"{ {k: n for k, n in counts.items() if n} }; {smi})")
    if not line["nee_speedup_holds"]:
        raise AssertionError("convergence: NEE's speed-up does not hold")
    for k in ("closest_lean_tree", "occluded"):
        if counts[k] <= 0:
            raise AssertionError(f"convergence: {k} never launched")
    return counts


# --------------------------------------------------------------------------
# The glTF / Whitted pipeline and the instanced kernels K9 / K10
# --------------------------------------------------------------------------

def _whitted_camera(view, device):
    import numpy as np
    from tpu_pt_torch.camera import Camera
    from tpu_pt_torch.render import CameraArrays
    return CameraArrays.from_camera(Camera(
        eye=np.array(view["eye"], np.float32),
        lookat=np.array(view["lookat"], np.float32), fov_y=view["fov_y"]),
        device=device)


def _render_whitted(ws, device, view, frames, tap=None, **cfg_kw):
    """Render ``frames`` progressive Whitted frames; returns (accum, u8,
    per-frame [(seconds, rays, stats)]). ``tap`` (a context manager) is
    entered around the first frame only, the warm-up, so that its reads
    stay out of the timed frames."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.render import init_accum
    cfg = tp.RenderConfig(**cfg_kw)
    cam = _whitted_camera(view, device)
    accum = init_accum(cfg, device=device)
    out, u8 = [], None

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    for f in frames:
        sync()
        t0 = time.perf_counter()
        with (tap if tap is not None and f == frames[0]
              else contextlib.nullcontext()):
            accum, u8, stats = tp.render_whitted_frame(ws, cam, cfg, f,
                                                       accum)
        sync()
        out.append((time.perf_counter() - t0,
                    int(stats.rays_traced) + int(stats.shadow_rays), stats))
    return accum, u8, out


def phase_whitted_goldens(device):
    """tools/make_goldens.py's two Whitted goldens through the kernels on
    the card, RMSE < 0.01."""
    import numpy as np
    import tpu_pt_torch as tp
    from tpu_pt_torch import film
    for name, scene, view, kw in WHITTED_GOLDENS:
        ws = tp.load_gltf(str(ASSETS / scene), device=device)
        accum, u8, per = _render_whitted(ws, device, view, [0, 1], **kw)
        _check_frame(name, accum, per)
        golden = film.read_png(str(GOLDENS / f"{name}.png"))
        err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                        golden.astype(np.float32) / 255.0)
        say("goldens", f"{name}: RMSE {err:.5f} "
            f"({sum(p[0] for p in per) * 1e3:.1f} ms for 2 frames)")
        if not err < GOLDEN_RMSE:
            raise AssertionError(f"{name}: RMSE {err} >= {GOLDEN_RMSE}")


def phase_whitted_main(device, smi):
    """Each Whitted main-path run with the launch counters zeroed just
    before it and read just after. Each run's warm-up frame also records,
    for every kernel it launches, one call's arguments on each table (a
    call with parked lanes where there is one: on the forest at the bench
    view every path ends at its first hit and no lane is parked). An
    instanced run launches K10 once per shadow call. Returns (launches
    summed per kernel, {run tag: recorded calls})."""
    import tpu_pt_torch as tp
    launches = dict.fromkeys(KERNELS, 0)
    recorded = {}
    for tag, scene, inst_mode, frames, timed, kw, expect in WHITTED_RUNS:
        t0 = time.perf_counter()
        ws = tp.load_gltf(str(ASSETS / scene), instancing=inst_mode,
                          device=device)
        load_s = time.perf_counter() - t0
        if scene == FOREST and (ws.inst is None or ws.inst.count != 1001):
            raise AssertionError("auto must keep the forest's 1,001 "
                                 "instances")
        tap = _Tap(INTERSECT_WRAPPERS)
        _zero_counters()
        with _shadow_calls() as calls:
            accum, _, per = _render_whitted(ws, device, WHITTED_VIEW, frames,
                                            tap=tap, **kw)
        counts = _read_counters()
        recorded[tag] = tap.picked
        _check_frame(tag, accum, per)
        # K10's walk once per instanced shadow call.
        if counts["occluded_inst"] != calls[0]:
            raise AssertionError(f"{tag}: occluded_inst launched "
                                 f"{counts['occluded_inst']} times in "
                                 f"{calls[0]} instanced shadow calls")
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        iters = [int(p[2].wavefront_iterations) for p in per[-timed:]]
        shadow = [int(p[2].shadow_rays) for p in per[-timed:]]
        geo = (f"{ws.inst.count} instances of {ws.geom.num_tris} unique "
               f"triangles" if ws.inst is not None
               else f"{ws.geom.num_tris} triangles")
        note = ""
        if ws.inst is None:
            note = ("; shadow rays through "
                    + ("K8 (occluded_clustered)"
                       if counts["occluded_clustered"] else
                       "K2 (occluded)" if counts["occluded"] else "none"))
        per_frame = {k: round(n / len(frames), 2) for k, n in counts.items()
                     if n}
        say("whitted", f"{tag}: {geo}, loaded in {load_s:.2f} s; "
            f"{sec / timed * 1e3:.1f} ms/frame, {rays / sec / 1e6:.3f} "
            f"Mrays/s over {timed} frame(s), {rays // timed} rays/frame "
            f"(shadow {shadow}), rounds {iters}; launches "
            f"{ {k: n for k, n in counts.items() if n} } over "
            f"{len(frames)} frames, per frame {per_frame}{note}; {smi}")
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"{tag}: {k} never launched")
            if not any(name == k for name, _ in tap.picked):
                raise AssertionError(f"{tag}: no {k} call was recorded")
        for k, n in counts.items():
            launches[k] += n
    say("whitted", f"kernel launches on the Whitted main path: "
        f"{ {k: n for k, n in launches.items() if n} }")
    return launches, recorded


@contextlib.contextmanager
def _shadow_calls():
    """Counts the calls of ``instanced.occluded_hit`` (the instanced
    shadow entry point) with at least one ray, in ``[count]``."""
    from tpu_pt_torch.intersect import instanced
    real, calls = instanced.occluded_hit, [0]

    def count(tables, origins, *args, **kw):
        calls[0] += origins.shape[0] > 0
        return real(tables, origins, *args, **kw)
    instanced.occluded_hit = count
    try:
        yield calls
    finally:
        instanced.occluded_hit = real


def _inst_work(o, d, bound, tables, out_bytes: int, occluded=None):
    """A walk of the instance tree needs its instance-node tests at each
    ray's ``bound`` (its closest hit or shadow tmax: _inst_node_tests)
    and the node table read; for each instance box a ray pierces up to
    ``bound``, the transform and a slab test per cluster of its mesh; and
    the rows of every cluster it pierces up to ``bound``. An occluded
    shadow ray needs one cluster's rows per pierced instance at most."""
    import torch
    from tpu_pt_torch.intersect import clustered, instanced
    table = tables.table
    n, n_inst = o.shape[0], table.rows.shape[0]
    cluster = clustered.CLUSTER
    omax = o.abs().amax(1)
    flops = int(_inst_node_tests(o, d, bound, tables, occluded).sum()) \
        * BOX_FLOPS
    wb = table.boxes
    meta = table.rows[:, 12:14].round().long().tolist()
    for i, (clo, ncl) in enumerate(meta):
        if ncl == 0:
            continue
        m = wb[i, 6] * omax + wb[i, 7]
        sel = _slab_pass(o, d, wb[i:i + 1, 0:3], wb[i:i + 1, 3:6], m, 0.01,
                         bound)[:, 0].nonzero()[:, 0]
        if not sel.numel():
            continue
        om, dm = instanced._xform(table.rows[i:i + 1, 0:12], o[sel], d[sel])
        mm = clustered.BOX_MARGIN * (tables.scale + om.abs().amax(1))
        cb = tables.boxes[clo:clo + ncl]
        cnt = _slab_pass(om, dm, cb[:, 0:3], cb[:, 3:6], mm, 0.01,
                         bound[sel]).sum(1)
        if occluded is not None:
            cnt = torch.where(occluded[sel], cnt.clamp_max(1), cnt)
        flops += sel.numel() * (XFORM_FLOPS + ncl * BOX_FLOPS) \
            + int(cnt.sum()) * cluster * PAIR_FLOPS
    nbytes = (n * (24 + (4 if occluded is not None else 0))
              + tables.tris.shape[0] * 64 + tables.boxes.shape[0] * 32
              + n_inst * 96 + tables.tree.nodes.shape[0] * 48
              + n * out_bytes)
    return flops, nbytes


def _inst_node_tests(o, d, bound, tables, occluded=None):
    """Instance-node and instance-box tests [N] of a walk of the instance
    tree at each ray's ``bound`` (``_inst_tree_leaves_plain``). For an
    any-hit (``occluded`` given) a ray with an empty interval (bound at or
    below tmin: parked and ineligible shadow rays) tests nothing, and an
    occluded one needs one root-to-leaf path, 2 * depth + 1 tests."""
    import torch
    from tpu_pt_torch.intersect import clustered, instanced
    tests = torch.cat([instanced._inst_tree_leaves_plain(
        o[a:a + 4096], d[a:a + 4096], tables.tree, tables.table.boxes, 0.01,
        bound[a:a + 4096])[1] for a in range(0, o.shape[0], 4096)])
    if occluded is not None:
        depth = clustered.tree_depth(tables.tree.nodes.shape[0] + 1)
        tests = torch.where(occluded, tests.clamp_max(2 * depth + 1), tests)
        tests = torch.where(bound > 0.01, tests, 0)
    return tests


def _inst_rays(ws, tables, device, seed: int, n_rays: int,
               view=WHITTED_VIEW):
    """n_rays rays on the card: camera rays of ``view`` through
    jittered pixels of a square grid, then as many leaving the surfaces
    K9 finds (a hit's world normal side, random directions; misses leave
    the eye); plus shadow rays from those points to the scene's first
    light, tmax 0.001 short of it."""
    import numpy as np
    import torch
    from tpu_pt_torch import rng
    from tpu_pt_torch.intersect import instanced
    from tpu_pt_torch.render import camera_rays
    half = n_rays // 2
    side = int(round(half ** 0.5))
    cam = _whitted_camera(view, device)
    pix = torch.arange(half, device=device)
    jx, jy = rng.uniform2(pix, 0, seed, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, side, half // side, jx, jy)
    h = instanced.closest_hit(tables, o, d)
    nrm = torch.where((h.normal * d).sum(1, keepdim=True) > 0, -h.normal,
                      h.normal)
    p = torch.where(h.hit[:, None], o + d * h.t[:, None] + 1e-3 * nrm, o)
    r = np.random.default_rng(seed)
    rd = torch.as_tensor(r.normal(size=(half, 3)).astype(np.float32),
                         device=device)
    rd = torch.where((rd * nrm).sum(1, keepdim=True) < 0, -rd, rd)
    rd = rd / rd.norm(dim=1, keepdim=True)
    sp = torch.cat([p, p])
    to_l = ws.light_pos[0] - sp
    dist = to_l.norm(dim=1)
    shadow = (sp.contiguous(), (to_l / dist[:, None]).contiguous(),
              (dist - 0.001).contiguous())
    return (torch.cat([o, p]).contiguous(), torch.cat([d, rd]).contiguous(),
            shadow)


def _fixture(device, count: int = 9):
    """tests/test_instanced.py's fixture, built by the port: a cube and a
    glass tetrahedron instanced nine times (rotations, non-uniform scales,
    one mirrored instance), or its first ``count`` instances. Returns
    (tables, instance list)."""
    import numpy as np
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import instanced
    cv = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                   for z in (0, 1)], np.float32) - 0.5
    cf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                   [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                   [1, 5, 7], [1, 7, 3]], np.int64)
    tv = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                  np.float32) - 0.25
    tf = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int64)
    mats = [dict(diffuse=(0.8, 0.2, 0.2), emission=(0, 0, 0), roughness=0.5,
                 metallic=0.0, ior=1.5, bsdf=0),
            dict(diffuse=(0.9, 0.9, 0.9), emission=(0, 0, 0), roughness=0.0,
                 metallic=0.0, ior=1.5, bsdf=tp.scene.BSDF_REFRACTION)]
    geom = tp.scene.build_scene_arrays(
        np.concatenate([cv, tv]), np.concatenate([cf, tf + len(cv)]),
        np.concatenate([np.zeros(len(cf), np.int64),
                        np.ones(len(tf), np.int64)]), mats, device=device)
    rng = np.random.default_rng(7)
    instances = []
    for i in range(9):
        if i == 8:
            scale = [-1.0, 1.0, 1.0]
        elif i % 3 == 0:
            scale = (0.4 + rng.random(3)).tolist()
        else:
            scale = [0.5 + 0.5 * rng.random()] * 3
        tx, ang = rng.random(3) * 8 - 4, rng.random() * 6
        c, s_ = np.cos(ang), np.sin(ang)
        rot = [np.array([[1, 0, 0], [0, c, -s_], [0, s_, c]]),
               np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]]),
               np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])][i % 3]
        m = np.eye(4)
        m[:3, :3] = rot * np.asarray(scale)
        m[:3, 3] = tx
        instances.append((i % 2, m))
    table = instanced.build_instance_table(
        [(0, len(cf)), (len(cf), len(cf) + len(tf))],
        [(cv.min(0), cv.max(0)), (tv.min(0), tv.max(0))],
        instances[:count])
    return instanced.prepare(geom, table), instances


def _aimed_rays(instances, n, seed, device):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    targets = np.stack([m[:3, 3] for _, m in instances])
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 12
    d = targets[rng.integers(0, len(targets), n)] - o \
        + rng.normal(size=(n, 3)) * 0.3
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(2.0, 20.0, n)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)
    return t(o), t(d), t(tmax)


def phase_inst_kernels(device, records):
    """K9 and K10 against their plain versions on the card, bitwise: (b)
    on the forest at the frame's width with every eighth lane parked,
    timed there and at N_RAYS (there against the plain version too), and
    K10 again on shadow rays from the surfaces seen from above the
    forest's edge, of which some reach the light; on foliage at the
    frame's width (K10 over its opaque subset, the table its shadow rays
    take); (c) on the port's build of the mirrored / non-uniform fixture,
    K10 also on tables of one and two of its instances. Each walk's bound
    comes from its own instance-node tests. (a), the recorded calls of the
    Whitted runs, follows in phase_whitted_calls."""
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, instanced
    from tpu_pt_torch.render import PARK_COORD
    ws = tp.load_gltf(str(ASSETS / FOREST), device=device)
    tables = instanced.prepare(ws.geom, ws.inst)

    def k9(o, d, tb=tables):
        return instanced.closest_inst(o, d, tb.tris, tb.boxes, tb.scale,
                                      tb.table.rows, tb.table.boxes, 0.01,
                                      1e16, tb.tree)

    def k9_plain(o, d, tb=tables):
        return instanced._closest_inst_plain(o, d, tb.tris, clustered.CLUSTER,
                                             tb.table.rows, 0.01)

    def k10(o, d, tmax, tb=tables):
        return instanced.occluded_inst(o, d, tmax, tb.tris, tb.boxes,
                                       tb.scale, tb.table.rows,
                                       tb.table.boxes, 0.01, tb.tree)

    def k10_plain(o, d, tmax, tb=tables):
        out = [instanced._occluded_inst_plain(
            o[a:a + 65536], d[a:a + 65536], tmax[a:a + 65536], tb.tris,
            clustered.CLUSTER, tb.table.rows, 0.01)
            for a in range(0, o.shape[0], 65536)]
        return torch.cat(out)

    rows = tables.tris.shape[0]
    o, d, shadow = _inst_rays(ws, tables, device, 5, N_INST_RAYS)
    (ob, db), shadow_b = _park((o, d), shadow, PARK_EVERY)
    oW, dW, shadow_W = _inst_rays(ws, tables, device, 6, N_RAYS)
    torch.cuda.synchronize()
    _check_kernel(records, "closest_inst", lambda: k9(ob, db),
                  lambda: k9_plain(ob, db), rows, _compare_exact,
                  lambda out: _inst_work(ob, db, out[0], tables, 12),
                  n=N_INST_RAYS, reps=10, plain_reps=1,
                  at_n_rays=lambda: k9(oW, dW))
    rec = records["closest_inst"][-1]
    live = int((ob[:, 0] != PARK_COORD).sum())
    tests = int(_inst_node_tests(ob, db, k9(ob, db)[0], tables).sum())
    rec["node_tests_per_ray"] = tests / live
    say("kernels", f"closest_inst: the instance tree, "
        f"{tables.tree.nodes.shape[0]} nodes over {tables.table.count} "
        f"instances; a walk at the final bound tests {tests / live:.2f} "
        f"instance boxes and nodes a live ray (of "
        f"{tables.table.rows.shape[0]} instance boxes)")
    err, extra = _compare_exact("closest_inst", k9(oW, dW), k9_plain(oW, dW))
    records["closest_inst"].append(dict(rows=rows, rays=N_RAYS,
                                        max_abs_err=err))
    say("kernels", f"closest_inst: forest, {N_RAYS} rays against the plain "
        f"version: max|err| {err} ({extra})")

    # K10: the walk at each shadow ray's tmax, its bound from its own
    # node tests (an occluded ray: one path).
    _check_kernel(records, "occluded_inst", lambda: k10(*shadow_b),
                  lambda: k10_plain(*shadow_b), rows, _compare_exact,
                  lambda out: _inst_work(shadow_b[0], shadow_b[1],
                                         shadow_b[2], tables, 1,
                                         occluded=out),
                  n=N_INST_RAYS, reps=10, plain_reps=1,
                  at_n_rays=lambda: k10(*shadow_W))
    rec = records["occluded_inst"][-1]
    _k10_node_tests(rec, "forest, 16,384 parked", shadow_b, k10(*shadow_b),
                    tables)
    err, extra = _compare_exact("occluded_inst", k10(*shadow_W),
                                k10_plain(*shadow_W))
    records["occluded_inst"].append(dict(rows=rows, rays=N_RAYS,
                                         max_abs_err=err))
    say("kernels", f"occluded_inst: forest, {N_RAYS} shadow rays against "
        f"the plain version: max|err| {err} ({extra})")

    # From the bench view inside the forest every live shadow ray is
    # blocked, so that set cannot fail a K10 that always says "blocked".
    # Shadow rays from what is seen from above the edge (canopy tops,
    # open ground, misses leaving the eye) are blocked only in part.
    _, _, shadow = _inst_rays(ws, tables, device, 8, N_INST_RAYS,
                              view=FOREST_VIEW)
    _, shadow_e = _park((o, d), shadow, PARK_EVERY)
    out_k, out_p = k10(*shadow_e), k10_plain(*shadow_e)
    torch.cuda.synchronize()
    share = float(out_k[shadow_e[2] > 0].float().mean())
    err, extra = _compare_exact("occluded_inst", out_k, out_p)
    records["occluded_inst"].append(dict(rows=rows, rays=N_INST_RAYS,
                                         max_abs_err=err))
    say("kernels", f"occluded_inst: forest shadow rays from above the edge, "
        f"{N_INST_RAYS} rays, one in {PARK_EVERY} parked: {share:.4f} of "
        f"the live ones blocked; max|err| {err} ({extra})")
    if not 0.0 < share < 1.0:
        raise AssertionError("the forest shadow rays from above the edge "
                             f"must be blocked only in part ({share})")
    _k10_node_tests(rec, "forest from above the edge", shadow_e, out_k,
                    tables)
    rec["ms_edge"] = gpu_ms(lambda: k10(*shadow_e), 10)

    # Foliage (601 instances, kept instanced) at the frame's width; its
    # shadow rays take K10 over the opaque subset (301 real instances).
    fol = tp.load_gltf(str(ASSETS / "foliage.gltf"), instancing="instanced",
                       device=device)
    ft = instanced.prepare(fol.geom, fol.inst)
    fo, fd, fshadow = _inst_rays(fol, ft, device, 9, N_INST_RAYS)
    (fo, fd), fshadow = _park((fo, fd), fshadow, PARK_EVERY)
    out_k = k9(fo, fd, ft)
    err, extra = _compare_exact("closest_inst", out_k, k9_plain(fo, fd, ft))
    records["closest_inst"].append(dict(rows=ft.tris.shape[0],
                                        rays=N_INST_RAYS, max_abs_err=err))
    records["closest_inst"][0]["ms_foliage"] = gpu_ms(lambda: k9(fo, fd, ft),
                                                      10)
    say("kernels", f"closest_inst: foliage, {N_INST_RAYS} rays, one in "
        f"{PARK_EVERY} parked: max|err| {err} ({extra}); "
        f"{records['closest_inst'][0]['ms_foliage']:.4f} ms")
    ao = fol.alpha_occ
    fot = instanced.prepare(ao.occ_geom, ao.occ_inst)
    out_k = k10(*fshadow, fot)
    err, extra = _compare_exact("occluded_inst", out_k,
                                k10_plain(*fshadow, fot))
    records["occluded_inst"].append(dict(rows=fot.tris.shape[0],
                                         rays=N_INST_RAYS, max_abs_err=err))
    flops, nbytes = _inst_work(*fshadow, fot, 1, occluded=out_k)
    rec.update(foliage_bound_ms=_bound(flops, nbytes)["bound_ms"],
               ms_foliage=gpu_ms(lambda: k10(*fshadow, fot), 10))
    say("kernels", f"occluded_inst: foliage's opaque subset "
        f"({fot.tree.nodes.shape[0] + 1} real instances), {N_INST_RAYS} "
        f"shadow rays, one in {PARK_EVERY} parked: max|err| {err} ({extra}); "
        f"{rec['ms_foliage']:.4f} ms, bound {rec['foliage_bound_ms']:.4f}")
    _k10_node_tests(rec, "foliage's opaque subset", fshadow, out_k, fot)

    fx, instances = _fixture(device)
    fo, fd, ftmax = _aimed_rays(instances, 4096, 7, device)
    checks = [("closest_inst", "", k9(fo, fd, fx), k9_plain(fo, fd, fx)),
              ("occluded_inst", "", k10(fo, fd, ftmax, fx),
               k10_plain(fo, fd, ftmax, fx))]
    # Tables of one (a root leaf, no node) and two of its instances.
    for k in (1, 2):
        sub = _fixture(device, k)[0]
        checks.append(("occluded_inst", f", its first {k} instance(s)",
                       k10(fo, fd, ftmax, sub),
                       k10_plain(fo, fd, ftmax, sub)))
    for name, which, out_k, out_p in checks:
        torch.cuda.synchronize()
        err, extra = _compare_exact(name, out_k, out_p)
        records[name].append(dict(rows=fx.tris.shape[0], rays=4096,
                                  max_abs_err=err))
        say("kernels", f"{name}: the mirrored / non-uniform fixture{which}, "
            f"4096 aimed rays: max|err| {err} ({extra})")


def _k10_node_tests(rec, what: str, shadow, occluded, tables) -> None:
    """Say (and keep on ``rec``) the instance-node tests a live shadow
    ray of K10's walk makes at its tmax, blocked and unblocked apart."""
    from tpu_pt_torch.render import PARK_COORD
    tests = _inst_node_tests(*shadow, tables, occluded)
    live = (shadow[0][:, 0] != PARK_COORD) & (shadow[2] > 0.01)
    per = {}
    for k, sel in (("blocked", live & occluded), ("open", live & ~occluded)):
        n = int(sel.sum())
        per[k] = float(tests[sel].sum()) / n if n else 0.0
    rec.setdefault("node_tests_per_ray", {})[what] = per
    say("kernels", f"occluded_inst, {what}: {int(live.sum())} live shadow "
        f"rays, {float(occluded[live].float().mean()):.4f} blocked; node "
        f"tests a blocked ray {per['blocked']:.2f} (one path), an open one "
        f"{per['open']:.2f} (of {tables.tree.nodes.shape[0]} nodes)")


def phase_whitted_calls(recorded, records):
    """(a) Every kernel call recorded from a Whitted run's warm-up frame
    (the forest's K9 / K10, pbr_big's K6 / K8 on its 100,354 rows at the
    run's width, foliage's K9 on the main and the alpha-subset tables and
    its K10 on the opaque subset) against its plain version on the same
    arguments, bitwise."""
    for tag, picked in recorded.items():
        _hold_recorded(records, picked, tag.split(" ")[0])


def _write_city(path):
    """tests/test_instanced.py's small glTF: one 12-triangle cube with
    vertex normals, instanced 12 times (rotations, scales) on a grid."""
    import base64
    import numpy as np
    cv = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                   for z in (0, 1)], np.float32) - 0.5
    cf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                   [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                   [1, 5, 7], [1, 7, 3]], np.int64)
    nrm = cv / np.linalg.norm(cv, axis=1, keepdims=True)
    pos_b, nrm_b = cv.tobytes(), nrm.astype(np.float32).tobytes()
    idx_b = cf.astype(np.uint16).tobytes()
    blob = pos_b + nrm_b + idx_b
    rng = np.random.default_rng(5)
    nodes = []
    for i in range(12):
        ang, s_ = float(rng.random() * 6), float(0.6 + rng.random())
        c, sn = np.cos(ang), np.sin(ang)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * s_
        m[:3, 3] = [(i % 4) * 3.0 - 4.5, 0.0, (i // 4) * 3.0 - 3.0]
        nodes.append(dict(mesh=0, matrix=[float(x) for x in m.T.reshape(-1)]))
    doc = dict(
        asset=dict(version="2.0"), scene=0,
        scenes=[dict(nodes=list(range(12)))], nodes=nodes,
        meshes=[dict(primitives=[dict(attributes=dict(POSITION=0, NORMAL=1),
                                      indices=2, material=0)])],
        materials=[dict(pbrMetallicRoughness=dict(
            baseColorFactor=[0.7, 0.6, 0.5, 1.0], metallicFactor=0.0,
            roughnessFactor=0.8))],
        accessors=[dict(bufferView=0, componentType=5126, count=8,
                        type="VEC3"),
                   dict(bufferView=1, componentType=5126, count=8,
                        type="VEC3"),
                   dict(bufferView=2, componentType=5123, count=cf.size,
                        type="SCALAR")],
        bufferViews=[dict(buffer=0, byteOffset=0, byteLength=len(pos_b)),
                     dict(buffer=0, byteOffset=len(pos_b),
                          byteLength=len(nrm_b)),
                     dict(buffer=0, byteOffset=len(pos_b) + len(nrm_b),
                          byteLength=len(idx_b))],
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())])
    path.write_text(json.dumps(doc))


def phase_whitted_cross_check(device):
    """The forest instanced (K9/K10) against flattened (K6/K8) on the
    card, within tests/test_torch_instanced.py's bound; then a small
    instanced scene on the CPU (plain versions) against the card."""
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import instanced
    view = dict(eye=(0.0, 7.0, 14.0), lookat=(0.0, 0.0, 0.0), fov_y=45.0)
    imgs = {}
    for mode in ("instanced", "flatten"):
        t0 = time.perf_counter()
        ws = tp.load_gltf(str(ASSETS / FOREST), instancing=mode,
                          device=device)
        t1 = time.perf_counter()
        accum, _, per = _render_whitted(ws, device, FOREST_VIEW, [0],
                                        **FOREST_CROSS)
        _check_frame(f"forest {mode}", accum, per)
        imgs[mode] = accum.cpu()
        say("cross-check", f"forest {mode} ({ws.geom.num_tris} triangles"
            f"): loaded in {t1 - t0:.2f} s, {FOREST_CROSS} frame "
            f"{per[0][0] * 1e3:.1f} ms")
    err = float(((imgs["instanced"] - imgs["flatten"]) ** 2).mean().sqrt())
    say("cross-check", f"forest instanced vs flattened: RMSE {err:.3e} "
        f"(bound {INST_FLAT_RMSE})")
    if not err < INST_FLAT_RMSE:
        raise AssertionError("the instanced and flattened forests disagree")

    city = BUILD_ASSETS / "city.gltf"
    BUILD_ASSETS.mkdir(parents=True, exist_ok=True)
    _write_city(city)
    out = []
    for dev in ("cpu", device):
        ws = tp.load_gltf(str(city), instancing="instanced", device=dev)
        before = instanced.LAUNCHES["closest_inst"]
        accum, _, per = _render_whitted(ws, dev, view, [0], **CITY_CROSS)
        _check_frame(f"city on {dev}", accum, per)
        if (instanced.LAUNCHES["closest_inst"] > before) != (dev != "cpu"):
            raise AssertionError("K9 must launch on the card only")
        out.append((accum.cpu(), per[0][0]))
    (cpu_img, cpu_s), (card_img, card_s) = out
    line = _image_bound("the CPU and card city frames", cpu_img, card_img,
                        PIXEL_TOL, PIXEL_SHARE)
    say("cross-check", f"instanced city {CITY_CROSS}: CPU {cpu_s:.1f} s, "
        f"card {card_s:.2f} s; {line}")


# Path-trace runs of ``--profile pt``: bench.py's frame unfused, under
# fused_nee and on regen; the sphere box unfused and under fused_nee.
PROFILE_PT = [
    ("bench frame, pixelq", "cornell_box_mixed.obj", {}),
    ("bench frame, pixelq, fused_nee", "cornell_box_mixed.obj",
     dict(fused_nee=True)),
    ("bench frame, regen", "cornell_box_mixed.obj", dict(scheduler="regen")),
    ("sphere box, pixelq", "cornell_box_sphere.obj", {}),
    ("sphere box, pixelq, fused_nee", "cornell_box_sphere.obj",
     dict(fused_nee=True)),
]


def _profile_frame(tag, render_one, wall_ms, rounds, smi):
    """Run ``render_one()`` (one frame) under torch.profiler and report
    device busy = the summed time of the device's own events (kernels,
    copies, fills; one stream, so they do not overlap), against
    ``wall_ms``, the same frame's unprofiled wall time. The host-side op
    entries (``aten::mul`` ...) carry the device time of the kernels they
    launch as well, so they are left out, or that time would count
    twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_one()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    if not by_name:
        raise RuntimeError(f"{tag}: the profile holds no device events")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = {k: round(v, 3) for k, v in by_name.items()
            if "_kernel" in k and ("inst" in k or "clustered" in k
                                   or "closest" in k or "occluded" in k)}
    say("profile", f"{tag}: unprofiled frame {wall_ms:.1f} ms, {rounds} "
        f"rounds, device busy {busy:.1f} ms ({busy / wall_ms:.1%}), idle "
        f"{1 - busy / wall_ms:.1%}; intersection kernels {ours}; top "
        + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top) + f"; {smi}")


def _profile_big(device, smi):
    """The big-mesh frame through each pair of clustered kernels, the lean
    one before and after each other variant."""
    import tpu_pt_torch as tp
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    big = phase_assets(device)
    kw = dict(BENCH_BIG, use_direct_lighting=True,
              use_importance_sampling=True)
    cfg = tp.RenderConfig(**kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    order = [("lean (K6 + K8)", {})]
    for what, variables, _, _ in BIG_VARIANTS:
        order += [(what, variables), ("lean (K6 + K8)", {})]
    for what, variables in order:
        with _env(**variables):
            _, _, per = _render(big, device, [0, 1], **kw)
            accum = init_accum(cfg, device=device)
            _profile_frame(f"big mesh, {what} {variables or ''}".strip(),
                           lambda: render_frame(big, cam, cfg, 2, accum),
                           per[1][0] * 1e3,
                           int(per[1][2].wavefront_iterations), smi)


def _profile_pt(device, smi):
    """One profiled frame of each run of PROFILE_PT (``--profile pt``):
    frame 0 warms up, frame 1 is timed unprofiled, frame 2 runs under
    torch.profiler. Device busy is the summed device time of frame 2's
    kernels; idle is 1 - busy / frame 1's wall time."""
    import tpu_pt_torch as tp
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    scenes = {}
    bench_kw = next(r[4] for r in MAIN_RUNS if r[0] == REGEN_OF)
    for tag, scene_file, extra in PROFILE_PT:
        if scene_file not in scenes:
            scenes[scene_file] = tp.load_scene(str(ASSETS / scene_file),
                                               device=device)
        kw = dict(bench_kw if scene_file == "cornell_box_mixed.obj" else
                  next(r[4] for r in MAIN_RUNS if r[1] == scene_file),
                  use_direct_lighting=True, use_importance_sampling=True,
                  **extra)
        _, _, per = _render(scenes[scene_file], device, [0, 1], **kw)
        cfg = tp.RenderConfig(**kw)
        cam = CameraArrays.from_camera(tp.cornell_default_camera(),
                                       device=device)
        accum = init_accum(cfg, device=device)
        _profile_frame(f"{tag} ({kw['width']}^2 x {kw['spp']} spp)",
                       lambda: render_frame(scenes[scene_file], cam, cfg, 2,
                                            accum),
                       per[1][0] * 1e3, int(per[1][2].wavefront_iterations),
                       smi)


def _profile_whitted(device, smi):
    """One profiled frame of each Whitted main-path run (``--profile
    whitted``), as _profile_pt profiles."""
    import tpu_pt_torch as tp
    for tag, scene, inst_mode, _, _, kw, _ in WHITTED_RUNS:
        ws = tp.load_gltf(str(ASSETS / scene), instancing=inst_mode,
                          device=device)
        _, _, per = _render_whitted(ws, device, WHITTED_VIEW, [0, 1], **kw)
        cfg = tp.RenderConfig(**kw)
        cam = _whitted_camera(WHITTED_VIEW, device)
        accum = tp.init_accum(cfg, device=device)
        _profile_frame(tag, lambda: tp.render_whitted_frame(
            ws, cam, cfg, 2, accum), per[1][0] * 1e3,
            int(per[1][2].wavefront_iterations), smi)


def main() -> int:
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    device, smi = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--profile"]:
        # Each part fits one 1,200 s run; pt and whitted together took
        # 1,192.9 s on an H100 ("rest"), too close to the limit to share
        # a run.
        parts = {"pt": _profile_pt, "whitted": _profile_whitted,
                 "big": _profile_big}
        named = sys.argv[2:] or list(parts)
        for part in ("pt", "whitted") if named == ["rest"] else named:
            parts[part](device, smi)
        say("done", f"profiled in {time.perf_counter() - t0:.1f} s")
        return 0
    rng_rows = phase_rng(device, smi)
    big = phase_assets(device)
    records = phase_kernels(device, big)
    phase_fused_kernels(device, records)
    phase_goldens(device)
    phase_fused_goldens(device)
    phase_whitted_goldens(device)
    launches, twins = phase_main_path(device, smi, big, records)
    b_launches = phase_big_variants(device, smi, big, twins[BIG_TAG],
                                    records)
    f_launches = phase_fused_main(device, smi, twins, records)
    del twins
    w_launches, recorded = phase_whitted_main(device, smi)
    phase_inst_kernels(device, records)
    phase_whitted_calls(recorded, records)
    del recorded
    phase_cross_check(big)
    phase_lbvh(device, smi, big)
    phase_whitted_cross_check(device)
    h_launches = phase_huge_mesh(device, smi, records)
    i_launches = phase_incoherent(device, smi, big)
    l_launches = phase_list_caps(device, smi, big, records)
    p_launches = phase_bf16(device, smi, records)
    phase_entry_points(device, smi)
    d_launches = phase_multi_gpu(device, smi)
    phase_native(device, smi, big)
    v_launches = phase_viewer(device, smi)
    c_launches = phase_convergence(device, smi)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")

    import torch
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        first = records[kname][0]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=sum(part.get(kname, 0) for part in (
                launches, w_launches, f_launches, b_launches, h_launches,
                i_launches, l_launches, p_launches, d_launches, v_launches,
                c_launches)),
            max_abs_err=max(r["max_abs_err"] for r in records[kname]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            # No PyTorch call computes a closest or any ray-triangle hit,
            # nor K16's chain.
            library_ms=None, rays=first["rays"],
            # K12-K15: the schedule build and the whole path (build,
            # kernel, reduce, completion) beside the whole function's
            # bound; the list build (stream_lists, timed at the any-hit's
            # tile): also at the closest side's and at K15's tiles;
            # K16: ms per call over its 200 chained calls.
            # K6, K8: a call on the huge mesh (ms_huge). K5: the dense
            # count of its work beside the walk's (bound_ms). K9, K10:
            # foliage's calls (ms_foliage, K10's bound there too), K10
            # from above the forest's edge (ms_edge), instance-node tests
            # per ray. K1's to K4's walks: the dense count, and the walk
            # against its dense body in interleaved pairs, both times on
            # the walk's record (pair_ms_*, dense_pair_ms_*; _monkey: on
            # the monkey box, _reference: a recorded call of the
            # reference launch). K1's and K2's dense bodies: their own
            # paths' tables first, ms on the card back to back (events
            # around the host's calls: events_ms), every table's time
            # (ms_tables); K2's split: the culled sweep's own work
            # (culled_bound_ms) beside the dense bound.
            **{k: first[k] for k in ("build_ms", "path_ms", "path_bound_ms",
                                     "ms_closest", "ms_closest_at_n_rays",
                                     "ms_grp_closest", "ms_grp_any",
                                     "ms_global", "plain_ms_global",
                                     "ms_tiles",
                                     "path_bound_by", "bench_ms",
                                     "ms_at_n_rays", "ms_huge", "ms_foliage",
                                     "ms_edge", "foliage_bound_ms",
                                     "node_tests_per_ray", "dense_bound_ms",
                                     "pair_ms_narrow", "pair_ms_wide",
                                     "pair_ms_recorded",
                                     "dense_pair_ms_narrow",
                                     "dense_pair_ms_wide",
                                     "dense_pair_ms_recorded",
                                     "pair_ms_monkey", "dense_pair_ms_monkey",
                                     "pair_ms_reference",
                                     "dense_pair_ms_reference", "ms_tables",
                                     "events_ms", "culled_bound_ms")
               if k in first}))
    print(json.dumps({"kernels": kernels + rng_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
