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
and K8b: a thread block builds and sweeps a shared work list) and the rest
of the geometry (LBVH, scene-JSON and glTF-extras primitives and curves):

15. kernels (in phase 4): K6f, K7 lean, K7 full and K8b on the big mesh at
   32,768 rays with every eighth lane parked, bitwise against their plain
   versions (u and v included) and against K6 / K8 on the same rays, timed
   there and at 262,144 rays;
16. big-mesh variants: tools/bench_big.py's frame three more times, under
   ``TPT_LEAN_BIG=0`` (K6f + K8, K6 never), ``TPT_INKB=1`` (K7 lean + K8b,
   K6 and K8 never) and both (K7 full + K8b), each accumulator equal to
   the lean frame's bit for bit; pbr_big.glb's Whitted frame under
   ``TPT_LEAN_UV=0`` (K6f with u, v) against the lean one within
   tests/test_torch_whitted.py's bound; one call of each new wrapper
   recorded from a warm-up frame, bitwise;
17. huge mesh: ``tools/make_assets.py --huge`` (1,001,124 triangles) under
   build/assets, loaded (seconds spent writing, parsing, ordering, building
   the LBVH and packing), bench_big's frame through K6 + K8 and through
   K7 + K8b: NOT_DONE == 0, finite, the two accumulators equal;
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
   also at 1,000 and 77 rays; K12 with the guard on and off, K13 at
   ``CBIN_GROUP`` 1 and 8 and with starved caps, K11 under an unknown, the
   oracle and a cycled wrong prediction; the kernels and their schedule
   builds (``stream_candidates``, ``cbin_pairs``) timed apart;
21. big-mesh variants (in phase 16): the frame under ``TPT_SEED=1``,
   ``TPT_STREAM=1`` and ``TPT_CBIN=1``, accumulators bitwise equal to the
   lean frame's, the selected wrappers launched once per round (K13's
   frame also K12 and K8, its completion passes), the replaced ones
   never; the lean frame again under ``TPT_PRED=0``, bitwise equal; one
   call of each wrapper recorded from a warm-up frame, bitwise;
22. incoherent rays: ``tools/bench_incoherent_torch.py``'s 262,144 random
   rays on the big mesh through every scheduler (K6, K7, K11, K12, K13,
   K14, K15 serial and bundled; K8, K8b, K12, K13, K14, K15 both), all
   results equal, device times in interleaved pairs against K6 / K8.

The rest of pallas_ablations.py (K14 pair-binned, K15 8-lane groups:
``tpu_pt_torch/csrc/ablations_binned.cu``) and the bf16 probe K16:

23. kernels (in phase 4): ``closest_binned`` / ``occluded_binned`` (k = 12)
   and ``closest_grp`` / ``occluded_grp`` (serial and bundled) on the big
   mesh at 32,768 rays with every eighth lane parked, bitwise against
   their plain versions, timed apart from their schedule builds
   (``_pair_schedule``, the group lists) and at 262,144 rays; their whole
   paths bitwise against K6 / K8 there and at 1,000 and 77 rays, K14 also
   at k = 2, where the completion pass carries real lanes;
24. big-mesh variants (in phase 16): the frame under ``TPT_BINNED=1``
   (K14 and its completion passes K6 and K8 once per round), ``TPT_GRP=1``
   and ``TPT_GRP=2`` (K15 once per round, K6 / K8 never), accumulators
   bitwise equal to the lean frame's, one call of each wrapper recorded
   from a warm-up frame and held bitwise;
25. incoherent rays (in phase 22): K14 and K15 among the paths;
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

Every kernel's record carries its bound: the larger of the operations
these inputs need over the card's f32 rate and the bytes over its memory
rate (K16: its operations over the instruction rate of its type, from the
card's SM count and maximum SM clock).

The last three lines are the kernels' JSON record, the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.
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
                "occluded_binned", "closest_grp", "occluded_grp")
# The wrappers the incoherent phase must launch (its lean closest path
# takes no full carry).
INCOHERENT_WRAPPERS = NEW_WRAPPERS[4:]
N_RAGGED = (1000, 77)    # ray counts that leave a ragged last block
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
    from tpu_pt_torch import _kernels
    t0 = time.perf_counter()
    libs = _kernels.build()
    _kernels._entry_points()
    say("build", f"{len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log = lib.with_suffix(".log")
        usage = [ln.strip() for ln in (log.read_text().splitlines()
                                       if log.exists() else [])
                 if "registers" in ln or "spill" in ln]
        say("build", f"{lib.name}: " + " | ".join(usage))


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
    main and alpha-subset tables, is kept once for each)."""

    def __init__(self, names):
        self.names, self.picked = tuple(names), {}

    def __enter__(self):
        import torch
        from tpu_pt_torch.render import PARK_COORD
        self.saved = {k: getattr(_kernel_module(k), k) for k in self.names}

        def rank(parked):
            return (parked < 1.0) + (1.0 / PARK_EVERY <= parked < 1.0)

        def keep(a):
            if isinstance(a, tuple):        # K12's lists
                return tuple(keep(x) for x in a)
            return a.clone() if torch.is_tensor(a) else a

        def tap(name, wrapper):
            def call(*args):
                parked = float((args[0][:, 0] == PARK_COORD).float().mean())
                key = (name, tuple(a.data_ptr() for a in args[2:]
                                   if torch.is_tensor(a) and a.dim() == 2))
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
    if name in ("closest_cbin", "occluded_cbin"):
        return ablations._cbin_sweep_plain(*args,
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


def _dense_occluded_work(o, d, tmax, rows):
    """An any-hit sweep in row order needs, per ray, the rows up to its
    first blocking one, or every row when nothing blocks."""
    import torch
    from tpu_pt_torch.intersect import dense
    n, r = o.shape[0], rows.shape[0]
    pairs = 0
    for a in range(0, n, 16384):
        t, _, _ = dense._pe_block(o[a:a + 16384], d[a:a + 16384], rows,
                                  0.01)
        block = (t < tmax[a:a + 16384, None]) & (rows[None, :, 13] < 0.5)
        first = block.to(torch.int32).argmax(1)
        pairs += int(torch.where(block.any(1), first + 1, r).sum())
    return pairs * PAIR_FLOPS, n * 28 + r * 64 + n


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


def _cbin_work(pair_rays, rows, jtab, cluster: int, rt: int, occluded: bool):
    """K13's own work, from the wrapper's inputs: every live pair lane (a
    job with a cluster, a ray that is not the parked sentinel) against its
    job's rows, all of them for the closest hit, up to the first blocking
    one for the any-hit. Bytes: the pair rays and the job table in, each
    distinct cluster's rows once, 8 (t, row) or 4 bytes per lane out."""
    import torch
    from tpu_pt_torch.intersect import ablations
    j_cap = jtab.shape[0]
    live = ((jtab >= 0)[:, None]
            & (pair_rays.view(j_cap, rt, 8)[:, :, 0] < 1e7)).view(-1)
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
    return pairs * PAIR_FLOPS, pair_rays.numel() * 4 + j_cap * 4 \
        + used * cluster * 64 + j_cap * rt * (4 if occluded else 8)


def _binned_work(rays, rows, schedule, cluster: int, occluded: bool):
    """K14's own work, from the wrapper's inputs: every used pair slot of
    a live tile against its tile's rows, all of them for the closest hit,
    up to the first blocking one for the any-hit; no slab test (those ran
    in the schedule build). Bytes: the rays, the slot and tile tables in,
    each distinct cluster's rows once, one 8-byte key or one flag per ray
    out."""
    import torch
    from tpu_pt_torch.intersect import ablations
    pair_ray, tile_sid = schedule.pair_ray, schedule.tile_sid
    ns = rows.shape[0] // cluster
    live = ((tile_sid < ns)[:, None]
            & (pair_ray.view(-1, ablations.PAIR_TILE) >= 0))
    pairs = int(live.sum()) * cluster
    if occluded:
        pairs = 0
        table = rows.view(ns, cluster, 16)
        for j0 in range(0, tile_sid.shape[0], 64):
            sid = tile_sid[j0:j0 + 64].long().clamp_max(ns - 1)
            lv = live[j0:j0 + 64]
            pr = rays[pair_ray.view(-1, ablations.PAIR_TILE)[j0:j0 + 64]
                      .long().clamp_min(0)]
            blk = table[sid]
            t = ablations._pe_rows(pr[..., 0:3], pr[..., 3:6], blk, 0.01)
            block = (t < pr[..., 6:7]) & (blk[:, None, :, 13] < 0.5)
            first = block.to(torch.int32).argmax(2)
            need = torch.where(block.any(2), first + 1, cluster)
            pairs += int(need[lv].sum())
    used = int(torch.unique(tile_sid[tile_sid < ns]).numel())
    return pairs * PAIR_FLOPS, rays.numel() * 4 + pair_ray.numel() * 4 \
        + tile_sid.numel() * 4 + used * cluster * 64 \
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
    kernel, reduce, completion pass) is timed too, beside K6's / K8's
    bound (``path_ms``, ``path_bound_ms``). Then each whole path bitwise
    against K6 / K8 (``k6_out``, ``k8_out``) under every knob setting,
    there and at N_RAGGED rays."""
    import torch
    from tpu_pt_torch.intersect import ablations, clustered
    rows, boxes, scale = tb.rows, tb.boxes, tb.scale
    rt, cluster = ablations.RAY_TILE_C, rows.shape[0] // boxes.shape[0]
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

    def k11(o, d, pred):
        return ablations.closest_rotated(o, d, *table, pred, srows, 0.01)
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

    # K12: lists built once, the kernel timed alone.
    r8 = ablations.pack_rays(o, d, 1e16, n)
    s8 = ablations.pack_rays(*shadow, n)
    rW = ablations.pack_rays(oW, dW, 1e16, oW.shape[0])
    sW = ablations.pack_rays(*shadow_wide, oW.shape[0])

    def lists_of(r, closest, lanes=rt):
        return ablations.stream_candidates(r, boxes, scale, lanes, 0.01,
                                           1e16 if closest else r[:, 6])
    lc, lo, lcW, loW = (lists_of(r8, True), lists_of(s8, False),
                        lists_of(rW, True), lists_of(sW, False))
    say("kernels", f"stream_candidates: tiles of {rt} lanes list "
        f"{float(lc[2].float().mean()):.1f} (closest) and "
        f"{float(lo[2].float().mean()):.1f} (any-hit) of {boxes.shape[0]} "
        f"boxes at {n} rays")
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
        lambda: ablations.occluded_streamed(s8, *table, lo, rt, 0.01),
        lambda: ablations._streamed_plain(s8, *table, lo, rt, 0.01, 1e16,
                                          True, True),
        streamed_work(lo, occluded_work),
        lambda: ablations.occluded_streamed(sW, *table, loW, rt, 0.01),
        build=lambda: lists_of(s8, False),
        path=lambda: ablations.occluded_stream_path(*shadow, *table, 0.01),
        path_work=occluded_work)

    # K13: the job table built once, the per-pair kernel timed alone.
    pc, po = (ablations.cbin_pairs(r, boxes, scale, 0.01) for r in (r8, s8))
    pcW, poW = (ablations.cbin_pairs(r, boxes, scale, 0.01)
                for r in (rW, sW))
    say("kernels", f"cbin_pairs: {int((pc[1] >= 0).sum())} (closest) and "
        f"{int((po[1] >= 0).sum())} (any-hit) of {pc[1].shape[0]} jobs of "
        f"{rt} pair lanes used at {n} rays; "
        f"{float(pc[3].float().mean()):.4f} / {float(po[3].float().mean()):.4f}"
        f" of lanes incomplete")
    for name, sweep, p, pW, work, r, path in (
            ("closest_cbin", ablations.closest_cbin, pc, pcW, closest_work,
             r8, lambda: ablations.closest_cbin_path(o, d, *table, 0.01)),
            ("occluded_cbin", ablations.occluded_cbin, po, poW,
             occluded_work, s8,
             lambda: ablations.occluded_cbin_path(*shadow, *table, 0.01,
                                                  finish=k8_finish))):
        any_hit = name == "occluded_cbin"
        run(name, lambda: sweep(p[0], rows, p[1], cluster, rt, 0.01),
            lambda: ablations._cbin_sweep_plain(
                p[0], rows, p[1], cluster, rt, 0.01, occluded=any_hit),
            lambda out: _cbin_work(p[0], rows, p[1], cluster, rt, any_hit),
            lambda: sweep(pW[0], rows, pW[1], cluster, rt, 0.01),
            build=lambda: ablations.cbin_pairs(r, boxes, scale, 0.01),
            path=path, path_work=work)

    # K14: the pair schedule built once, the kernel (with its fused fold)
    # timed alone; its bound from its live pairs, no slab test.
    k14 = ablations.PAIR_K

    def pairs_of(r, closest, k=k14):
        return ablations._pair_schedule(r, boxes, scale, k, 0.01,
                                        1e16 if closest else r[:, 6])
    bc, bo, bcW, boW = (pairs_of(r8, True), pairs_of(s8, False),
                        pairs_of(rW, True), pairs_of(sW, False))
    ns = boxes.shape[0]
    say("kernels", f"_pair_schedule (k {k14}): "
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

    # The whole paths against K6 / K8 under every knob, at n and at ragged
    # ray counts.
    def with_caps(caps, fn):
        """fn() under (CBIN_GROUP, CBIN_PAIR_MULT, CBIN_K_OUT) = caps."""
        names = ("CBIN_GROUP", "CBIN_PAIR_MULT", "CBIN_K_OUT")
        saved = [getattr(ablations, k) for k in names]
        for k, v in zip(names, caps):
            setattr(ablations, k, v)
        try:
            return fn()
        finally:
            for k, v in zip(names, saved):
                setattr(ablations, k, v)

    starved = (1, 1, 2)
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
        for caps in ((1, 12, 32), (8, 12, 32), starved):
            for what, fn, want in (("closest", cbin_c, want_c),
                                   ("any-hit", cbin_o, want_o)):
                checks.append((f"K13 {what}, group / pair mult / k {caps}",
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
            f"off), K13 (3 cap settings, one starved), K14 (k {k14} and 2) "
            f"and K15 (serial, bundled), closest and any-hit paths: "
            f"{len(checks)} results bitwise equal to K6 / K8 on {m} rays")
    share = float(with_caps(starved, lambda: ablations.cbin_pairs(
        r8, boxes, scale, 0.01))[3].float().mean())
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
    return counts


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


def phase_kernels(device, big):
    import torch
    import tpu_pt_torch as tp
    from tpu_pt_torch.intersect import clustered, dense, kernel_module
    mixed = tp.load_scene(str(ASSETS / "cornell_box_mixed.obj"), device=device)
    sphere = tp.load_scene(str(ASSETS / "cornell_box_sphere.obj"),
                           device=device)
    tm, ts = dense.prepare(mixed), dense.prepare(sphere)
    records = {}

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
    # carry, with u and v), K7 lean and full and K8b (the block's shared
    # work list), each bitwise against its plain version, then against
    # K6 / K8. The bound is the least the card could take for the function:
    # K6's work (K8's) per ray, whatever list a block shares; the full
    # carry writes 32 bytes per ray.
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
    t6, row6 = k6(ob, db)
    f6 = full(clustered.closest_clustered_full, ob, db)
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
        accum, _, per = _render(scenes[scene_file], device, frames, tap=tap,
                                use_direct_lighting=True,
                                use_importance_sampling=True, **kw)
        counts = _read_counters()
        _check_frame(tag, accum, per)
        sec = sum(p[0] for p in per[-timed:])
        rays = sum(p[1] for p in per[-timed:])
        iters = [int(p[2].wavefront_iterations) for p in per[-timed:]]
        say("main", f"{tag}: {sec / timed * 1e3:.1f} ms/frame, "
            f"{rays / sec / 1e6:.3f} Mrays/s over {timed} frame(s), "
            f"{rays // timed} rays/frame, rounds {iters}; launches "
            f"{ {k: n for k, n in counts.items() if n} }; {smi}")
        for k in expect:
            if counts[k] <= 0:
                raise AssertionError(f"{tag}: {k} never launched")
        rounds = sum(int(p[2].wavefront_iterations) for p in per)
        for k in once:
            if counts[k] != rounds:
                raise AssertionError(f"{tag}: {k} launched {counts[k]} "
                                     f"times in {rounds} rounds")
        for k in banned:
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
        if not same:
            raise AssertionError(f"{tag}: the frame differs from the lean "
                                 "one (bound: bitwise)")
        for k, n in counts.items():
            launches[k] += n
        _hold_recorded(records, tap.picked, f"bench_big ({what})",
                       all_parked_ok=("closest_streamed",)
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
        (arrays, "nee_occluder_index"), (lbvh, "build_lbvh"))]
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
        f"{spent['nee_occluder_index']:.1f} s, LBVH build on the card "
        f"{spent['build_lbvh']:.1f} s); packing {packed * 1e3:.1f} ms "
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
    p_launches = phase_bf16(device, smi, records)
    phase_entry_points(device, smi)
    d_launches = phase_multi_gpu(device, smi)
    say("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")

    import torch
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        first = records[kname][0]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=sum(part.get(kname, 0) for part in (
                launches, w_launches, f_launches, b_launches, h_launches,
                i_launches, p_launches, d_launches)),
            max_abs_err=max(r["max_abs_err"] for r in records[kname]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            # No PyTorch call computes a closest or any ray-triangle hit,
            # nor K16's chain.
            library_ms=None, rays=first["rays"],
            # K12-K15: the schedule build and the whole path (build,
            # kernel, reduce, completion) beside the whole function's
            # bound; K16: ms per call over its 200 chained calls.
            # K6, K8: a call on the huge mesh (ms_huge). K5: the dense
            # count of its work beside the walk's (bound_ms). K9, K10:
            # foliage's calls (ms_foliage, K10's bound there too), K10
            # from above the forest's edge (ms_edge), instance-node tests
            # per ray. K1's to K4's walks: the dense count, and the walk
            # against its dense body in interleaved pairs, both times on
            # the walk's record (pair_ms_*, dense_pair_ms_*; _monkey: on
            # the monkey box, _reference: a recorded call of the
            # reference launch).
            **{k: first[k] for k in ("build_ms", "path_ms", "path_bound_ms",
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
                                     "dense_pair_ms_reference")
               if k in first}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
