// Dense single-slab ray-triangle kernels for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of the single-slab path
// (tpu_pt/intersect/pallas_bf.py):
//
//   tpt_closest_lean  <- _closest_kernel_lean (body _lean_sweep), launched by
//                        _closest_call_lean: per ray, the minimum t over all
//                        packed rows and the lowest row among equal t.
//   tpt_closest_lean_tree
//                     <- the same: tpt_closest_lean's function as a walk of a
//                        kd copy of the table (below), for a table of at
//                        most 2,048 rows whose copy has clusters.
//   tpt_closest_full  <- _closest_kernel (body _closest_sweep), launched by
//                        _closest_call: the same, clipped at a finite tmax,
//                        plus the winner's normal, material and u/v.
//   tpt_closest_full_tree
//                     <- the same: tpt_closest_full's function as a walk of
//                        a kd copy of the table (below), for a table that
//                        has one (above 2,048 rows).
//   tpt_occluded      <- _occluded_kernel (body _occlusion_sweep), launched by
//                        _occluded_call: is any non-refractive row hit with
//                        tmin < t < tmax_ray?
//   tpt_occluded_split
//                     <- the same: tpt_occluded's function over a row split
//                        of the table (below), for calls of at least
//                        dense.OCC_SPLIT_MIN_RAYS rays.
//   tpt_occluded_tree <- the same: tpt_occluded's function as a walk of a kd
//                        copy of the NEE occluder subset, for a subset of
//                        more than 2,048 rows.
//   tpt_closest_nee_lean
//                     <- _closest_nee_kernel_lean, launched by
//                        _closest_nee_call_lean: tpt_closest_lean's sweep,
//                        then the NEE shadow ray from the hit point to the
//                        light point (lz1, lz2), swept any-hit over the
//                        occluder subset rows.
//   tpt_closest_nee_lean_tree
//                     <- the same: tpt_closest_nee_lean's function as a walk
//                        of the table's kd copy, the shadow ray over the
//                        occluder subset's copy, or over the subset's rows
//                        when it has none.
//   tpt_closest_nee_full
//                     <- _closest_nee_kernel, launched by _closest_nee_call:
//                        tpt_closest_full's function (no u/v), then the
//                        same shadow ray any-hit over all rows; since the
//                        redesign a walk of a kd copy of the table (below).
//
// The per-pair test is pe_test of pe_block.cuh, shared with the clustered
// kernels.
//
// The dense bodies of K1-K4 (closest_kernel, occluded_kernel,
// closest_nee_kernel) serve the tables with no kd copy: cornell_box.obj's
// 32 rows (K1, K3, K4) and the NEE occluder subsets of at most 2,048 rows
// (K2: the mixed box's 24 rows take every shadow ray of the flagship
// frames). What bounds them on this card: the instruction rate and the
// latency of each pair's dependent chain. A pair is ~28 flops, but with
// --fmad=false every multiply and add is an instruction: ~60 SASS ones
// a pair with the IEEE reciprocal, its range check, the shared loads and
// the loop, whose steps wait on each other, against 28 bytes of ray data
// and a table of 2 KB. The design:
// - The block stages the table through shared memory, 256 rows a tile,
//   and every thread reads each row as a broadcast; the any-hit block
//   stops staging once all its rays are blocked or done (a parked lane's
//   tm of 0 is done before the first row).
// - A thread tests kRowsAnIter (3) rows an iteration: their pair tests do
//   not depend on each other, so their loads and reciprocals overlap
//   where one row's chain would stall the warp. The closest hit still
//   takes rows in ascending order with a strict <.
// - One ray a thread, 256 threads a block (kThreads). A trial on a
//   frame's replayed calls (PERF.md) found two rays a thread slower (~72
//   registers against ~61: the lower occupancy costs more than one row's
//   loads serving two rays saves) and 128 threads no faster.
// Trials refuted more designs (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W):
// a lazy pair test (t first, the edge functions only when some lane of
// the warp has t in range) skips little, since a warp's 32 shadow rays
// diverge (t is in range for ~32% of pairs but on ~52% of (warp, row)
// steps), and costs votes and branches; reading a small table straight
// from the cache, with no barrier, lost to the staged tile at every size;
// and, for the closest hits, a warp queue of the pairs whose plane t is
// in range (the plane half of every pair, a ballot a row appending
// tmin < t < best to the warp's queue, the edge half of 32 queued pairs
// at a time on the warp's lanes, folded into their rays in row order
// without atomics; tools/dense_ab_torch.py's _queue_shares models its
// order) took 1.7-2.1x the sweep's time in three designs, 9x in two that
// fold by a warp minimum over each ray's lanes (redux.sync under a mask
// that differs between lanes serialises). About 40% of cornell_box.obj's
// pairs are in range, and the plane half with a ballot a row, nothing
// queued, already takes ~83% of the whole sweep's time: the edge half it
// would skip is too small a part of a pair. So the closest bodies test
// every pair whole.
// The fused kernels run both sweeps in one launch: the shadow ray never
// leaves registers, and one launch replaces two.
//
// K2's shadow rays need far fewer pairs than a sweep of every row: on a
// flagship frame's calls a ray meets 38% of the mixed box's four groups
// (a block's 10 rows, the light's 2, the right wall's 2) and tests 5.4
// pairs of 24, but a warp's 32 rays diverge, so that 88% of (warp,
// group) steps have a ray that meets the group and one ray a thread
// would step through 20 rows of 24. So from dense.OCC_SPLIT_MIN_RAYS rays
// K2 sweeps a row split of its table (dense.row_split,
// occluded_split_kernel): the rows every ray sweeps (one ray a thread,
// as above), then groups of up to 16 rows with a box each, cut on the
// host by the surface-area heuristic, grown by the kd copies' per-ray
// margin. Each
// ray tests the boxes of a tile's groups (independent tests); a ballot a
// group lists the warp's lanes that meet it; the pairs of all of them
// (lane, row) go into one list that the warp's 32 lanes take 32 at a
// time, each pair reading its ray from the warp's slots in shared memory
// and its row from the tile, staged as four planes so that lanes that
// read different rows read consecutive words; a blocking pair sets its
// ray's bit with a shared atomicOr. Below that count the card holds too
// few warps to hide the queue's latency and the sweep of every row wins.
// Trials (PERF.md) refuted the cull for the closest hits of
// cornell_box.obj's 32 rows (K1, K3, K4) and for K4's shadow ray: one
// ray a thread over the groups it meets (the warps diverge), a queue a
// group (a warp synchronisation and a pass a group), a queue with a
// fold of each hit into (t, row) by a 64-bit shared atomicMin (a
// compare-and-swap loop), pairs listed row by row and two pairs a lane a
// step were all slower than the sweep of every row there, which those
// kernels keep, as they keep it against the queue of in-range pairs
// (above).
//
// K5 is different: its table (the sphere box, 2,280 rows) is five times
// K4's, and it is swept twice, once for the closest hit and once more by
// the shadow ray over every row, while most rows are the sphere, a small
// corner of the box. A dense body does 2 x 2,280 pair tests a ray, the
// block stopping its shadow sweep only when all 256 of its rays are
// blocked; with --fmad=false every multiply and add issues alone, so no
// cheaper pair test stays bitwise. So the work itself is cut:
// dense.prepare keeps a kd copy of the table (dense.kd_tables). The few
// triangles that span the scene (a box's walls, floor, ceiling and
// blocks: 32 of the sphere box's 2,264) would
// stretch the box of any cluster they fell in over the whole room, so
// they lead the copy as `n_top` rows that every ray sweeps; the rest are
// cut into 128-row clusters in balanced-kd order with boxes and their
// cluster_tree. One ray goes to a group of G lanes: it sweeps the top
// rows, then walks the tree near first (walk_tree of walk.cuh, as K6 / K8
// do) with bound min(best, tmax), each reached cluster's rows split over
// the lanes and folded with xor shuffles; then the shadow ray, formed in
// registers as before, sweeps the top rows and walks the same tree
// any-hit with bound tm, stopping at its first blocking row. What bounds
// the walk: the top rows, the node tests and the clusters a ray reaches
// (a few of 18 on the sphere box), and the latency of each dependent
// node load, not the pair arithmetic.
//
// K3 and K2 on the same table are the two halves of K5's walk, each its
// own kernel (closest_walk, any_hit_walk): the sphere box's unfused frame
// swept all 2,280 rows for every closest hit and all 2,256 occluder rows
// for every shadow ray that nothing blocked. K3 walks K5's kd copy. K2's
// function is any-hit over the occluder subset, not over every row (the
// two differ on shadow rays that run within eps of a wall's plane,
// scene/arrays.nee_occluder_index), so it walks a kd copy of its own,
// built from the subset's triangles by the same rule. A shadow ray reads
// its own tmax and culls with its own origin's margin.
//
// K1 and K4 on the mixed box (432 rows) are the same story at a smaller
// size: with --fmad=false the dense sweep executes every multiply and add
// as an instruction of its own, ~45 a pair, so by an estimate from the
// code it already runs near the floor the instruction rate sets for a
// bitwise sweep (~0.15 ms at 262,144 rays), and only less work can
// help. 32
// of its rows span the room; the other 396 are the glass sphere, a small
// ball that most rays never come near. So a table of at most 2,048 rows
// whose kd copy has at least one cluster of rows outside the top rows
// (dense.prepare) is walked as K3 and K5 walk theirs: K1's walk is
// closest_walk with no tmax (t and the dense row out; the caller gathers
// the winner's row as after the dense body), K4's the same closest walk,
// then the shadow ray any-hit over the occluder subset: any_hit_walk over
// the subset's own kd copy when it has one, else the group's lanes split
// the subset's rows (a copy of top rows only: the mixed box's 24
// occluders all span the room). They take K3's widths: 4 lanes a ray win
// on a frame's first rounds (camera rays), 8 and 16 on some later ones,
// and 8 over a whole bench frame's calls.
//
// Correctness notes:
// - Ties: rows are visited in ascending order and the best is replaced
//   only on a strict t < best, which is the TPU kernels' "lowest row among
//   equal t" rule (pallas_bf.py:706-721). The walks of K3 and K5 visit
//   the kd rows in another order, so their compare and fold are on (t, id):
//   column 15 of a kd row is the row's index in the dense table, and the
//   lowest id among equal t wins, whatever the visit order (rays through
//   a shared edge tie often). The row output is that id; the normal,
//   material and u/v come from the winning kd row, which is the dense row
//   bit for bit.
// - NaN in u/v: on the TPU the full-carry kernel reduced u/v with masked
//   sums, and one degenerate row's NaN once poisoned them (the round-2/3
//   whitted shading bug, ARCHITECTURE.md:435-448, invisible to CPU tests).
//   Here no reduction exists: u and v are recomputed once, from the winning
//   row only, after the loop, and written as 0 on a miss (write_attrs of
//   pe_block.cuh, shared with the clustered full-carry kernels).
// - Padded and degenerate rows reject themselves through IEEE inf/NaN, and
//   the library is built with --fmad=false, so the kernels agree with the
//   plain PyTorch versions in dense.py bit for bit (see pe_block.cuh).
// - The shadow ray's 1/|to_light| is an IEEE sqrtf and an IEEE division
//   (not rsqrtf, ~2 ulp), as the plain version's 1 / torch.sqrt, and the
//   light point is formed as ((corner + v1 lz1) + v2 lz2) - p, the TPU
//   kernel's order. On a miss lane p is o + 1e16 d: the occlusion flag
//   there is written but meaningless (the caller masks it).

#include "walk.cuh"

namespace {

constexpr int kThreads = 256;   // rays per block, one thread per ray
constexpr int kTileRows = 256;  // packed rows staged per shared-memory tile
constexpr int kRowsAnIter = 3;  // rows a dense body's iteration tests
constexpr int kWarps = kThreads / 32;
constexpr int kTileGroups = 32;  // groups a split's tile holds at most
constexpr float kNeeEps = 0.01f;  // shadow-ray range shrink (pallas_bf.NEE_EPS)
using tpt::kCols;
using tpt::kTFar;
using tpt::load_ray;
using tpt::pe_test;
using tpt::Ray;
using tpt::stage_rows;
using tpt::write_attrs;

// Packed row j of a staged tile: its four float4.
struct TileRow {
  float4 a, b, c, e;
};

__device__ __forceinline__ TileRow tile_row(const float4* s_rows, int j) {
  return TileRow{s_rows[4 * j], s_rows[4 * j + 1], s_rows[4 * j + 2],
                 s_rows[4 * j + 3]};
}

// Ray r against the `count` rows of a staged tile (row indices first + j),
// closest hit: it takes a row only on a hit with t < best (and t < tmax
// with kClip), in ascending row order, so a tie keeps the lowest row.
// kRowsAnIter rows an iteration: their pair tests do not depend on each
// other, so their reciprocals and shared loads overlap.
template <bool kClip>
__device__ __forceinline__ void closest_rows(const Ray& r,
                                             const float4* s_rows, int first,
                                             int count, float tmin, float tmax,
                                             float& best, int& best_row) {
  constexpr int U = kRowsAnIter;
  int j = 0;
  for (; j + U <= count; j += U) {
    TileRow w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = tile_row(s_rows, j + u);
    float t[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      t[u] = pe_test(r, w[u].a, w[u].b, w[u].c, tmin);
      if (kClip && !(t[u] < tmax)) t[u] = kTFar;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t[u] < best) {
        best = t[u];
        best_row = first + j + u;
      }
    }
  }
  for (; j < count; ++j) {
    const TileRow w = tile_row(s_rows, j);
    float t = pe_test(r, w.a, w.b, w.c, tmin);
    if (kClip && !(t < tmax)) t = kTFar;
    if (t < best) {
      best = t;
      best_row = first + j;
    }
  }
}

// Ray r against the `count` rows of a staged tile, any-hit: does a
// non-refractive row (column 13 < 0.5) give pe_test an answer < tm? It
// returns after the first iteration that finds one.
__device__ __forceinline__ bool occluded_rows(const Ray& r, float tm,
                                              const float4* s_rows, int count,
                                              float tmin) {
  constexpr int U = kRowsAnIter;
  int j = 0;
  for (; j + U <= count; j += U) {
    TileRow w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = tile_row(s_rows, j + u);
    bool hit = false;
#pragma unroll
    for (int u = 0; u < U; ++u)
      hit |= (w[u].e.y < 0.5f) &
             (pe_test(r, w[u].a, w[u].b, w[u].c, tmin) < tm);
    if (hit) return true;
  }
  for (; j < count; ++j) {
    const TileRow w = tile_row(s_rows, j);
    if (!(w.e.y < 0.5f)) continue;  // refractive rows pass light
    if (pe_test(r, w.a, w.b, w.c, tmin) < tm) return true;
  }
  return false;
}

// Closest-hit sweep over rows [0, n_rows), staged tile by tile through
// s_rows by the whole block (every thread calls it; dead rays, zeros, hit
// nothing and help stage). With kClip, t >= tmax counts as a miss.
template <bool kClip>
__device__ __forceinline__ void closest_sweep(float4* s_rows, const Ray& r,
                                              const float* __restrict__ tris,
                                              int n_rows, float tmin,
                                              float tmax, float& best,
                                              int& best_row) {
  best = kTFar;
  best_row = 0;
  for (int base = 0; base < n_rows; base += kTileRows) {
    const int rows = min(kTileRows, n_rows - base);
    __syncthreads();  // the previous tile is no longer read
    stage_rows(s_rows, tris, base, rows);
    __syncthreads();
    closest_rows<kClip>(r, s_rows, base, rows, tmin, tmax, best, best_row);
  }
}

// Any-hit sweep: is a non-refractive row hit with tmin < t < tm? Nothing
// can block a ray whose (tmin, tm) is empty (a parked lane's tm is 0),
// unless tm > kTFar, where a miss blocks. The block stops staging once
// every ray of it is done. The first barrier also keeps s_rows from a
// previous sweep's readers.
__device__ __forceinline__ bool occluded_sweep(float4* s_rows, const Ray& r,
                                               bool live, float tm,
                                               const float* __restrict__ tris,
                                               int n_rows, float tmin) {
  bool done = !live || (!(tm > tmin) && !(kTFar < tm));
  bool blocked = false;
  for (int base = 0; base < n_rows; base += kTileRows) {
    if (__syncthreads_and(done)) break;
    const int rows = min(kTileRows, n_rows - base);
    stage_rows(s_rows, tris, base, rows);
    __syncthreads();
    if (!done) blocked = done = occluded_rows(r, tm, s_rows, rows, tmin);
  }
  return blocked;
}

// K1 (kFull false: t and row) and K3 (kFull true: also the full carry).
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
               const float* __restrict__ tris, int n_rays, int n_rows,
               float tmin, float tmax, int want_uv, float* __restrict__ t_out,
               int* __restrict__ row_out, float* __restrict__ nrm_out,
               int* __restrict__ mat_out, float* __restrict__ u_out,
               float* __restrict__ v_out) {
  __shared__ float4 s_rows[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  float best;
  int best_row;
  closest_sweep<kFull>(s_rows, r, tris, n_rows, tmin, tmax, best, best_row);
  if (!live) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
  if (kFull)
    write_attrs(tris, r, i, best, best_row, want_uv, nrm_out, mat_out, u_out,
                v_out);
}

// K2.
__global__ void __launch_bounds__(kThreads)
occluded_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                const float* __restrict__ tmax, const float* __restrict__ tris,
                int n_rays, int n_rows, float tmin,
                uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const float tm = live ? tmax[i] : 0.0f;
  const bool blocked = occluded_sweep(s_rows, r, live, tm, tris, n_rows, tmin);
  if (live) occ_out[i] = blocked ? 1 : 0;
}

// An any-hit sweep's table (dense.RowSplit): `rows` holds its opaque rows
// that can hit, those every ray sweeps first, then each group's;
// `groups` [n, 2] float4 is a group's box as slab_passes reads it, then
// its first row and row count as int bits; `tiles` [n_tiles] is what a
// block stages at a time: (first row, rows, first group, groups), no
// group for rows every ray sweeps. A ray's box test grows each box by
// margin * (scale + max_k |o_k|).
struct Split {
  const float4* __restrict__ rows;
  const float4* __restrict__ groups;
  const int4* __restrict__ tiles;
  int n_tiles;
  float scale;
  float margin;

  __device__ __forceinline__ float grow(const Ray& r) const {
    return margin * (scale + tpt::max_abs_origin(r));
  }
};

// A split's tile is staged as four planes of kTileRows float4, one for
// each float4 of a packed row, so that the lanes of the group queue, which
// read different rows of a plane at once, read consecutive words.
// Row j of the planes at s, and the copy of rows [first, first + count)
// (count <= kTileRows) into them by every thread of the block.
__device__ __forceinline__ TileRow plane_row(const float4* s, int j) {
  return TileRow{s[j], s[kTileRows + j], s[2 * kTileRows + j],
                 s[3 * kTileRows + j]};
}

__device__ __forceinline__ void stage_planes(float4* s,
                                             const float4* __restrict__ rows,
                                             int first, int count) {
  const float4* src = rows + 4 * (size_t)first;
  for (int k = threadIdx.x; k < count * 4; k += blockDim.x)
    s[(k & 3) * kTileRows + (k >> 2)] = src[k];
}

// Ray r against `count` staged rows of a split (opaque rows only): is
// one hit with tmin < t < tm? It returns after the first iteration that
// finds one.
__device__ __forceinline__ bool split_rows_blocked(const Ray& r, float tm,
                                                   const float4* s,
                                                   int count, float tmin) {
  constexpr int U = kRowsAnIter;
  int j = 0;
  for (; j + U <= count; j += U) {
    TileRow w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = plane_row(s, j + u);
    bool hit = false;
#pragma unroll
    for (int u = 0; u < U; ++u)
      hit |= pe_test(r, w[u].a, w[u].b, w[u].c, tmin) < tm;
    if (hit) return true;
  }
  for (; j < count; ++j) {
    const TileRow w = plane_row(s, j);
    if (pe_test(r, w.a, w.b, w.c, tmin) < tm) return true;
  }
  return false;
}

// A warp's queue: its lanes' rays (o, tm, d); for each group of the staged
// tile, the lanes whose ray meets it and (first row, rows, end of its
// pairs in the warp's list, 1 / rows); the lanes that are blocked.
struct WarpQueue {
  float4 ray[32][2];
  int4 group[kTileGroups];
  uint8_t lanes[kTileGroups][32];
  unsigned blocked;
};

// What a block of occluded_split_kernel keeps in shared memory: the
// staged tile (planes) and each warp's queue.
struct Shared {
  float4 rows[4 * kTileRows];
  WarpQueue q[kWarps];
};

// Bit g set when ray r meets group g of the tile (its box grown by m)
// within (tmin, bound]; none when `skip`. The tests do not depend on each
// other.
__device__ __forceinline__ unsigned tile_meets(const Ray& r,
                                               const tpt::Slab& slab, float m,
                                               const Split& sp, int4 tile,
                                               float tmin, float bound,
                                               bool skip) {
  unsigned met = 0u;
  for (int g = 0; g < tile.w; ++g) {
    const float4 a = __ldg(sp.groups + 2 * (tile.z + g));
    const float4 b = __ldg(sp.groups + 2 * (tile.z + g) + 1);
    if (!skip && tpt::slab_passes(r, slab, a, b, m, tmin, bound))
      met |= 1u << g;
  }
  return met;
}

// The pairs of the warp's rays with the groups of the tile that `met`
// marks for each (bit g: its ray meets group g), spread evenly over the
// 32 lanes, for the rays in q.ray: a ballot a group lists the lanes that
// meet it in q.lanes, an inclusive scan over the groups (lane g holds
// group g) places each group's pairs, (k-th of its lanes, row), in the
// warp's list, and lane L tests pairs L, L + 32, ..., a blocking pair
// setting its ray's bit in q.blocked. Returns false, having swept
// nothing, when no lane meets a group. Called by the whole warp.
__device__ __forceinline__ bool queue_pairs(WarpQueue& q, int lane,
                                            unsigned met, const Split& sp,
                                            int4 tile, const float4* planes,
                                            float tmin) {
  const unsigned full = 0xffffffffu;
  const unsigned below = (1u << lane) - 1u;
  unsigned mine = 0u;  // lane g: the lanes that meet group g
  for (int g = 0; g < tile.w; ++g) {
    const bool in = (met >> g) & 1u;
    const unsigned mask = __ballot_sync(full, in);
    if (in) q.lanes[g][__popc(mask & below)] = (uint8_t)lane;
    if (lane == g) mine = mask;
  }
  int first = 0, rows = 0;
  if (lane < tile.w) {
    const float4 b = __ldg(sp.groups + 2 * (tile.z + lane) + 1);
    first = __float_as_int(b.z) - tile.x;
    rows = __float_as_int(b.w);
  }
  int end = __popc(mine) * rows;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int v = __shfl_up_sync(full, end, k);
    if (lane >= k) end += v;
  }
  const int total = __shfl_sync(full, end, 31);
  if (total == 0) return false;
  if (lane < tile.w)
    q.group[lane] =
        make_int4(first, rows, end, __float_as_int(1.0f / (float)rows));
  __syncwarp();
  int g = 0, start = 0;
  int4 at = q.group[0];
  for (int p = lane; p < total; p += 32) {
    while (p >= at.z) {  // p only grows: walk up to its group
      start = at.z;
      at = q.group[++g];
    }
    // k = i / rows, exact: with rows <= 16 (dense.SPLIT_GROUP), (i + 0.5)
    // / rows lies at least 1 / 32 from an integer, and i < 32 * 16.
    const int i = p - start;
    const int k = (int)(((float)i + 0.5f) * __int_as_float(at.w));
    const int src = q.lanes[g][k];
    const float4 q0 = q.ray[src][0], q1 = q.ray[src][1];
    const TileRow row = plane_row(planes + at.x, i - k * at.y);
    if (pe_test(Ray{q0.x, q0.y, q0.z, q1.x, q1.y, q1.z}, row.a, row.b, row.c,
                tmin) < q0.w)
      atomicOr(&q.blocked, 1u << src);
  }
  __syncwarp();
  return true;
}

// Any-hit sweep over the split of `tris` (n_rows rows): is a
// non-refractive row hit with tmin < t < tm? Nothing can block a ray
// whose (tmin, tm) is empty (a parked lane's tm is 0). A ray whose tm is
// past kTFar, where a miss blocks, sweeps `tris` whole from memory (the
// split leaves out rows that can only miss). Every other ray sweeps the
// rows every ray sweeps, one ray a thread, until one blocks; then, tile
// by tile, each ray not yet blocked tests the boxes of the tile's groups
// within (tmin, tm], and the pairs of the warp's rays with the groups
// they meet go through the warp's queue (queue_pairs). The block stops
// staging once every ray of it is done; the first barrier also keeps
// sh.rows from a previous sweep's readers.
__device__ __forceinline__ bool occluded_split_sweep(
    Shared& sh, const Ray& r, bool live, float tm,
    const float* __restrict__ tris, int n_rows, const Split& sp, float tmin) {
  const int lane = threadIdx.x & 31;
  WarpQueue& q = sh.q[threadIdx.x >> 5];
  bool done = !live || !(tm > tmin);
  bool blocked = false;
  if (!done && kTFar < tm) {
    blocked = tpt::blocked_staged(r, reinterpret_cast<const float4*>(tris),
                                  n_rows, tmin, tm);
    done = true;
  }
  const tpt::Slab slab = tpt::make_slab(r);
  const float m = sp.grow(r);
  q.ray[lane][0] = make_float4(r.ox, r.oy, r.oz, tm);
  q.ray[lane][1] = make_float4(r.dx, r.dy, r.dz, 0.0f);
  if (lane == 0) q.blocked = 0u;
  for (int k = 0; k < sp.n_tiles; ++k) {
    if (__syncthreads_and(done)) break;
    const int4 tile = __ldg(sp.tiles + k);
    stage_planes(sh.rows, sp.rows, tile.x, tile.y);
    __syncthreads();
    if (tile.w == 0) {
      if (!done)
        blocked = done = split_rows_blocked(r, tm, sh.rows, tile.y, tmin);
      continue;
    }
    const unsigned met = tile_meets(r, slab, m, sp, tile, tmin, tm, done);
    if (queue_pairs(q, lane, met, sp, tile, sh.rows, tmin) &&
        ((q.blocked >> lane) & 1u))
      blocked = done = true;
  }
  return blocked;
}

// K2 over the split of its table (dense.occluded at 2^17 rays and more).
__global__ void __launch_bounds__(kThreads)
occluded_split_kernel(const float* __restrict__ orig,
                      const float* __restrict__ dir,
                      const float* __restrict__ tmax,
                      const float* __restrict__ tris, int n_rows, Split sp,
                      int n_rays, float tmin, uint8_t* __restrict__ occ_out) {
  __shared__ Shared sh;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  const float tm = live ? tmax[i] : 0.0f;
  const bool blocked =
      occluded_split_sweep(sh, r, live, tm, tris, n_rows, sp, tmin);
  if (live) occ_out[i] = blocked ? 1 : 0;
}

inline Split split_of(const float* rows, const float* groups,
                      const int* tiles, int n_tiles, float scale,
                      float margin) {
  return Split{reinterpret_cast<const float4*>(rows),
               reinterpret_cast<const float4*>(groups),
               reinterpret_cast<const int4*>(tiles), n_tiles, scale, margin};
}

// The NEE shadow ray of ray r's hit at t, in registers: from
// p = o + t d toward the light point corner + v1 a + v2 b; tm is
// |to_light| - eps (cu:1017).
__device__ __forceinline__ Ray shadow_ray(const Ray& r, float t, float a,
                                          float b,
                                          const float* __restrict__ light,
                                          float& tm) {
  Ray s;
  s.ox = r.ox + t * r.dx;
  s.oy = r.oy + t * r.dy;
  s.oz = r.oz + t * r.dz;
  const float tlx = light[0] + light[3] * a + light[6] * b - s.ox;
  const float tly = light[1] + light[4] * a + light[7] * b - s.oy;
  const float tlz = light[2] + light[5] * a + light[8] * b - s.oz;
  const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
  const float inv = 1.0f / sqrtf(fmaxf(dist2, 1e-12f));
  s.dx = tlx * inv;
  s.dy = tly * inv;
  s.dz = tlz * inv;
  tm = dist2 * inv - kNeeEps;
  return s;
}

// Fused closest hit + NEE shadow ray, as _closest_nee_kernel_lean: the
// lean (t, row) sweep with no clipping, then the shadow ray any-hit over
// the occluder rows, both sweeps through one tile (the any-hit sweep's
// first barrier waits for the closest sweep's readers).
// light = (corner xyz, v1 xyz, v2 xyz).
__global__ void __launch_bounds__(kThreads)
closest_nee_kernel(const float* __restrict__ orig,
                   const float* __restrict__ dir,
                   const float* __restrict__ lz1,
                   const float* __restrict__ lz2,
                   const float* __restrict__ tris, int n_rows,
                   const float* __restrict__ occ_tris, int n_occ,
                   const float* __restrict__ light, int n_rays, float tmin,
                   float* __restrict__ t_out, int* __restrict__ row_out,
                   uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[kTileRows * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r = live ? load_ray(orig, dir, i) : Ray{0, 0, 0, 0, 0, 0};
  float best;
  int best_row;
  closest_sweep<false>(s_rows, r, tris, n_rows, tmin, kTFar, best, best_row);

  Ray s{0, 0, 0, 0, 0, 0};
  float tm = 0.0f;
  if (live) s = shadow_ray(r, best, lz1[i], lz2[i], light, tm);
  const bool blocked = occluded_sweep(s_rows, s, live, tm, occ_tris, n_occ,
                                      tmin);
  if (!live) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_row : 0;
  occ_out[i] = blocked ? 1 : 0;
}

inline unsigned grid_for(int n_rays) {
  return (unsigned)((n_rays + kThreads - 1) / kThreads);
}

// The walks over a kd copy of a table (dense.kd_tables): `rows` holds
// first the n_top rows of the triangles that span the scene (walls,
// floor, blocks), swept by every ray, then the clusters of the rest
// (n_boxes x cluster rows in kd order), with boxes [n_boxes, 8] and their
// tree nodes [n_boxes - 1, 8] (clustered.cluster_tree); `margin` is the
// relative culling margin (clustered.BOX_MARGIN) and `scale` the boxes'.
struct KdCopy {
  const float4* __restrict__ rows;
  int n_top;
  const float4* __restrict__ bx;
  const float4* __restrict__ nd;
  int n_boxes;
  int cluster;
  float scale;
  float margin;

  // The tree as ray r culls it: margin * (scale + max_k |o_k|).
  __device__ __forceinline__ tpt::ClusterTree tree(const Ray& r) const {
    return tpt::ClusterTree{bx, nd, n_boxes,
                            margin * (scale + tpt::max_abs_origin(r))};
  }
};

// The closest hit of ray r with tmin < t < tmax over a kd copy, walked by
// the G lanes of group g (K1, K3, K4, K5): the top rows, then the tree near first
// with bound min(best, tmax), each reached cluster's rows split over the
// lanes and folded with xor shuffles on (t, id), the kd row carried (a
// copy with no clusters ends after its top rows). Every lane ends with
// the group's (best, best_id, best_row).
template <int G>
__device__ __forceinline__ void closest_walk(const Ray& r, const tpt::Group& g,
                                             const KdCopy& kd, float tmin,
                                             float tmax, int* s_ref,
                                             float* s_tn, float& best,
                                             int& best_id, int& best_row) {
  best = kTFar;
  best_id = 0;
  best_row = 0;
  // Kd rows [first, first + count), every G-th a lane, then the group's
  // fold: the lowest (t, id), the kd row carried.
  auto sweep = [&](int first, int count) {
    float tl = best;
    int il = best_id, rl = best_row;
    for (int j = g.lane; j < count; j += G) {
      const int row = first + j;
      const float4* p = kd.rows + 4 * (size_t)row;
      float t = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin);
      if (!(t < tmax)) t = kTFar;
      // A miss never replaces: the running best starts at (kTFar, 0).
      if (t <= tl && t < kTFar) {
        const int id = (int)__ldg(p + 3).w;
        if (t < tl || id < il) {
          tl = t;
          il = id;
          rl = row;
        }
      }
    }
#pragma unroll
    for (int k = G / 2; k >= 1; k >>= 1) {
      const float to = __shfl_xor_sync(g.mask, tl, k);
      const int io = __shfl_xor_sync(g.mask, il, k);
      const int ro = __shfl_xor_sync(g.mask, rl, k);
      if (to < tl || (to == tl && io < il)) {
        tl = to;
        il = io;
        rl = ro;
      }
    }
    best = tl;
    best_id = il;
    best_row = rl;
  };
  if (kd.n_top > 0) sweep(0, kd.n_top);
  if (kd.n_boxes == 0) return;
  tpt::walk_tree(r, tpt::make_slab(r), tmin, fminf(best, tmax), kd.tree(r), g,
                 s_ref, s_tn, [&](int c, float* bound) {
                   sweep(kd.n_top + c * kd.cluster, kd.cluster);
                   *bound = fminf(best, tmax);
                   return false;
                 });
}

// Is a non-refractive row of a kd copy hit by ray r with tmin < t < tm?
// Walked by the G lanes of group g (K2, K4's and K5's shadow rays): the
// top rows (one masked ballot), then the tree any-hit with bound tm,
// stopping at the first blocking row; a copy with no clusters (a table
// swept whole, K4's small subsets) ends after its top rows. Nothing can
// block when (tmin, tm) is empty; a box entered at tn >= tm holds no
// blocking hit, so the bound is tm throughout.
template <int G>
__device__ __forceinline__ bool any_hit_walk(const Ray& r, const tpt::Group& g,
                                             const KdCopy& kd, float tmin,
                                             float tm, int* s_ref,
                                             float* s_tn) {
  if (!(tm > tmin)) return false;
  if (kd.n_top > 0 &&
      tpt::cluster_blocked(r, kd.rows, 0, kd.n_top, G, g, tmin, tm))
    return true;
  if (kd.n_boxes == 0) return false;
  bool blocked = false;
  tpt::walk_tree(r, tpt::make_slab(r), tmin, tm, kd.tree(r), g, s_ref, s_tn,
                 [&](int c, float*) {
                   blocked = tpt::cluster_blocked(
                       r, kd.rows, kd.n_top + c * kd.cluster, kd.cluster, G,
                       g, tmin, tm);
                   return blocked;
                 });
  return blocked;
}

// K3 as a walk: one ray to a group of G lanes, closest_walk over the kd
// copy, then the full carry (normal, material, u/v with want_uv) from the
// winning kd row, which is the dense row bit for bit; the row output is
// its dense index (column 15).
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_full_tree_kernel(const float* __restrict__ orig,
                         const float* __restrict__ dir, KdCopy kd, int n_rays,
                         float tmin, float tmax, int want_uv,
                         float* __restrict__ t_out, int* __restrict__ row_out,
                         float* __restrict__ nrm_out,
                         int* __restrict__ mat_out, float* __restrict__ u_out,
                         float* __restrict__ v_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const Ray r = load_ray(orig, dir, i);
  float best;
  int best_id, best_row;
  closest_walk<G>(r, g, kd, tmin, tmax, s_ref[g.slot], s_tn[g.slot], best,
                  best_id, best_row);
  if (g.lane != 0) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_id : 0;
  write_attrs(reinterpret_cast<const float*>(kd.rows), r, i, best, best_row,
              want_uv, nrm_out, mat_out, u_out, v_out);
}

// K1 as a walk: one ray to a group of G lanes, closest_walk over the kd
// copy with no tmax; t and the dense row (column 15) out, as the dense
// body writes them.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_lean_tree_kernel(const float* __restrict__ orig,
                         const float* __restrict__ dir, KdCopy kd, int n_rays,
                         float tmin, float* __restrict__ t_out,
                         int* __restrict__ row_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const Ray r = load_ray(orig, dir, i);
  float best;
  int best_id, best_row;
  closest_walk<G>(r, g, kd, tmin, kTFar, s_ref[g.slot], s_tn[g.slot], best,
                  best_id, best_row);
  if (g.lane != 0) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_id : 0;
}

// K4 as a walk: K1's walk, then the shadow ray any_hit_walk over `occ`,
// the occluder subset's kd copy or its rows as top rows only.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_nee_lean_tree_kernel(const float* __restrict__ orig,
                             const float* __restrict__ dir,
                             const float* __restrict__ lz1,
                             const float* __restrict__ lz2, KdCopy kd,
                             KdCopy occ, const float* __restrict__ light,
                             int n_rays, float tmin,
                             float* __restrict__ t_out,
                             int* __restrict__ row_out,
                             uint8_t* __restrict__ occ_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dir, i);
  float best;
  int best_id, best_row;
  closest_walk<G>(r, g, kd, tmin, kTFar, s_ref[g.slot], s_tn[g.slot], best,
                  best_id, best_row);
  float tm;
  const Ray s = shadow_ray(r, best, lz1[i], lz2[i], light, tm);
  const bool blocked =
      any_hit_walk<G>(s, g, occ, tmin, tm, s_ref[g.slot], s_tn[g.slot]);
  if (g.lane != 0) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_id : 0;
  occ_out[i] = blocked ? 1 : 0;
}

// K2 as a walk: one ray to a group of G lanes, any_hit_walk over the kd
// copy of the NEE occluder subset with the ray's own tmax.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
occluded_tree_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dir,
                     const float* __restrict__ tmax, KdCopy kd, int n_rays,
                     float tmin, uint8_t* __restrict__ occ_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;
  const Ray r = load_ray(orig, dir, i);
  const bool blocked = any_hit_walk<G>(r, g, kd, tmin, tmax[i], s_ref[g.slot],
                                       s_tn[g.slot]);
  if (g.lane == 0) occ_out[i] = blocked ? 1 : 0;
}

// K5 as a walk: closest_walk over the kd copy of the whole table (the
// closest hit clipped at tmax; normal and material, no u/v), then the
// shadow ray, formed in registers as closest_nee_kernel forms it,
// any_hit_walk over the same copy.
template <int G>
__global__ void __launch_bounds__(tpt::kWalkThreads)
closest_nee_tree_kernel(const float* __restrict__ orig,
                        const float* __restrict__ dir,
                        const float* __restrict__ lz1,
                        const float* __restrict__ lz2, KdCopy kd,
                        const float* __restrict__ light, int n_rays,
                        float tmin, float tmax, float* __restrict__ t_out,
                        int* __restrict__ row_out, float* __restrict__ nrm_out,
                        int* __restrict__ mat_out,
                        uint8_t* __restrict__ occ_out) {
  __shared__ int s_ref[tpt::kWalkThreads / G][tpt::kStack];
  __shared__ float s_tn[tpt::kWalkThreads / G][tpt::kStack];
  const tpt::Group g = tpt::group_of_thread<G>();
  const int i = tpt::walk_ray<G>();
  if (i >= n_rays) return;  // whole groups leave together
  const Ray r = load_ray(orig, dir, i);
  float best;
  int best_id, best_row;
  closest_walk<G>(r, g, kd, tmin, tmax, s_ref[g.slot], s_tn[g.slot], best,
                  best_id, best_row);

  float tm;
  const Ray s = shadow_ray(r, best, lz1[i], lz2[i], light, tm);
  const bool blocked =
      any_hit_walk<G>(s, g, kd, tmin, tm, s_ref[g.slot], s_tn[g.slot]);
  if (g.lane != 0) return;
  t_out[i] = best;
  row_out[i] = best < kTFar ? best_id : 0;
  occ_out[i] = blocked ? 1 : 0;
  write_attrs(reinterpret_cast<const float*>(kd.rows), r, i, best, best_row,
              false, nrm_out, mat_out, nullptr, nullptr);
}

inline KdCopy kd_copy(const float* tris, int n_top, const float* boxes,
                      const float* nodes, int n_boxes, int cluster,
                      float scale, float margin) {
  return KdCopy{reinterpret_cast<const float4*>(tris), n_top,
                reinterpret_cast<const float4*>(boxes),
                reinterpret_cast<const float4*>(nodes), n_boxes, cluster,
                scale, margin};
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int (0 = success).
// The walks (tpt_closest_lean_tree, tpt_closest_full_tree,
// tpt_occluded_tree, tpt_closest_nee_lean_tree, tpt_closest_nee_full)
// take a kd copy: `tris` [n_top + n_boxes *
// cluster, 16], `boxes` [n_boxes, 8] and `nodes` [n_boxes - 1, 8] f32,
// 16-byte aligned, the boxes' scale and the relative culling margin
// (clustered.py, BOX_MARGIN), and the walk's lanes a ray (4, 8, 16 or
// 32).

int tpt_closest_lean(const float* orig, const float* dir, const float* tris,
                     int n_rays, int n_rows, float tmin, float* t_out,
                     int* row_out, void* stream) {
  closest_kernel<false><<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tris, n_rays, n_rows, tmin, kTFar, 0, t_out, row_out,
      nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

int tpt_closest_lean_tree(const float* orig, const float* dir,
                          const float* tris, int n_top, const float* boxes,
                          const float* nodes, int n_boxes, int cluster,
                          float scale, float margin, int n_rays, float tmin,
                          float* t_out, int* row_out, int group,
                          void* stream) {
  const KdCopy kd =
      kd_copy(tris, n_top, boxes, nodes, n_boxes, cluster, scale, margin);
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_lean_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, kd, n_rays, tmin, t_out,
                                   row_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The occluder subset of tpt_closest_nee_lean_tree is a kd copy
// (occ_n_boxes > 0) or its rows swept whole: occ_top = its row count,
// occ_boxes = occ_nodes = NULL, occ_n_boxes = occ_cluster = 0.
int tpt_closest_nee_lean_tree(
    const float* orig, const float* dir, const float* lz1, const float* lz2,
    const float* tris, int n_top, const float* boxes, const float* nodes,
    int n_boxes, int cluster, float scale, const float* occ_tris, int occ_top,
    const float* occ_boxes, const float* occ_nodes, int occ_n_boxes,
    int occ_cluster, float occ_scale, float margin, const float* light,
    int n_rays, float tmin, float* t_out, int* row_out, uint8_t* occ_out,
    int group, void* stream) {
  const KdCopy kd =
      kd_copy(tris, n_top, boxes, nodes, n_boxes, cluster, scale, margin);
  const KdCopy occ = kd_copy(occ_tris, occ_top, occ_boxes, occ_nodes,
                             occ_n_boxes, occ_cluster, occ_scale, margin);
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_nee_lean_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, lz1, lz2, kd, occ, light,
                                   n_rays, tmin, t_out, row_out, occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_closest_full(const float* orig, const float* dir, const float* tris,
                     int n_rays, int n_rows, float tmin, float tmax,
                     int want_uv, float* t_out, int* row_out, float* nrm_out,
                     int* mat_out, float* u_out, float* v_out, void* stream) {
  closest_kernel<true><<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tris, n_rays, n_rows, tmin, tmax, want_uv, t_out, row_out,
      nrm_out, mat_out, u_out, v_out);
  return (int)cudaGetLastError();
}

int tpt_occluded(const float* orig, const float* dir, const float* tmax,
                 const float* tris, int n_rays, int n_rows, float tmin,
                 uint8_t* occ_out, void* stream) {
  occluded_kernel<<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, n_rays, n_rows, tmin, occ_out);
  return (int)cudaGetLastError();
}

int tpt_occluded_split(const float* orig, const float* dir, const float* tmax,
                       const float* tris, int n_rows, const float* rows,
                       const float* groups, const int* tiles, int n_tiles,
                       float scale, float margin, int n_rays, float tmin,
                       uint8_t* occ_out, void* stream) {
  occluded_split_kernel<<<grid_for(n_rays), kThreads, 0,
                          (cudaStream_t)stream>>>(
      orig, dir, tmax, tris, n_rows,
      split_of(rows, groups, tiles, n_tiles, scale, margin), n_rays, tmin,
      occ_out);
  return (int)cudaGetLastError();
}

int tpt_closest_nee_lean(const float* orig, const float* dir, const float* lz1,
                         const float* lz2, const float* tris, int n_rows,
                         const float* occ_tris, int n_occ, const float* light,
                         int n_rays, float tmin, float* t_out, int* row_out,
                         uint8_t* occ_out, void* stream) {
  closest_nee_kernel<<<grid_for(n_rays), kThreads, 0, (cudaStream_t)stream>>>(
      orig, dir, lz1, lz2, tris, n_rows, occ_tris, n_occ, light, n_rays, tmin,
      t_out, row_out, occ_out);
  return (int)cudaGetLastError();
}

int tpt_closest_nee_full(const float* orig, const float* dir, const float* lz1,
                         const float* lz2, const float* tris, int n_top,
                         const float* boxes, const float* nodes, int n_boxes,
                         int cluster, float scale, float margin,
                         const float* light, int n_rays, float tmin,
                         float tmax, float* t_out, int* row_out,
                         float* nrm_out, int* mat_out, uint8_t* occ_out,
                         int group, void* stream) {
  const KdCopy kd =
      kd_copy(tris, n_top, boxes, nodes, n_boxes, cluster, scale, margin);
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_nee_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, lz1, lz2, kd, light, n_rays,
                                   tmin, tmax, t_out, row_out, nrm_out,
                                   mat_out, occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_closest_full_tree(const float* orig, const float* dir,
                          const float* tris, int n_top, const float* boxes,
                          const float* nodes, int n_boxes, int cluster,
                          float scale, float margin, int n_rays, float tmin,
                          float tmax, int want_uv, float* t_out, int* row_out,
                          float* nrm_out, int* mat_out, float* u_out,
                          float* v_out, int group, void* stream) {
  const KdCopy kd =
      kd_copy(tris, n_top, boxes, nodes, n_boxes, cluster, scale, margin);
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    closest_full_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, kd, n_rays, tmin, tmax, want_uv,
                                   t_out, row_out, nrm_out, mat_out, u_out,
                                   v_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

int tpt_occluded_tree(const float* orig, const float* dir, const float* tmax,
                      const float* tris, int n_top, const float* boxes,
                      const float* nodes, int n_boxes, int cluster,
                      float scale, float margin, int n_rays, float tmin,
                      uint8_t* occ_out, int group, void* stream) {
  const KdCopy kd =
      kd_copy(tris, n_top, boxes, nodes, n_boxes, cluster, scale, margin);
  const bool ok = tpt::with_group(group, [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    occluded_tree_kernel<G>
        <<<tpt::walk_grid(n_rays, G), tpt::kWalkThreads, 0,
           (cudaStream_t)stream>>>(orig, dir, tmax, kd, n_rays, tmin,
                                   occ_out);
  });
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // extern "C"
