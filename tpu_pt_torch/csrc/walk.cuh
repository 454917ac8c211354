// The near-first walk of a box tree by a group of lanes, shared by the
// clustered kernels (K6, K6f, K8: a kd tree over the clusters of a big
// table), the fused closest-hit + NEE kernel K5 (a kd copy of the dense
// table) and the instanced kernel K9 (a tree over the instances).
//
// One ray goes to a group of G lanes (a part of a warp). The group walks
// the tree together, depth first and near first: it tests both children
// of a node it opens against the current bound, goes on with the nearer
// one that passes and pushes the farther on a short stack in shared
// memory with its entry distance, which is held against the bound again
// when it is popped. At a leaf it calls the caller's leaf function, which
// may lower the bound (a closest hit) or stop the walk (an any-hit).
// Every lane of the group runs the walk on the same values, so its
// branches are group-uniform.
//
// A tree is a leaf table and a node table. A reference is 2 * index + 1
// for leaf `index`, 2 * index for node `index`; node 0 is the root when
// the tree has nodes. Two kinds:
//
// - ClusterTree: leaves [C, 8] f32 (min xyz, max xyz, -, -), nodes
//   [C - 1, 8] f32 (min xyz, max xyz, the two children's references as
//   int bits), every box grown by one margin m, the ray's
//   (clustered.cluster_tree).
// - InstanceTree: leaves [I, 8] f32 (min xyz, max xyz, a, b), nodes
//   [n - 1, 12] f32 (min xyz, max xyz, a, b, the children's references as
//   int bits, 0, 0), each box grown by its own margin a * max|o| + b
//   (instanced.instance_tree).
//
// Why the walk culls exactly what a flat test of every leaf culls: min
// and max are exact, and each rounded step of the slab test,
// (lo - m - o) * inv, is monotone in the box coordinate and in m. A
// cluster node's box is the exact union of its children's at the same m,
// so its interval contains each descendant's. An instance node also
// carries the element-wise max of its children's (a, b); m = a * max|o|
// + b is monotone in a and b for max|o| >= 0, and so is each rounded
// step (a product of non-negatives, then a sum), so a node's margin is at
// least each child's and its grown interval contains theirs. Either way
// a node passes whenever a leaf under it passes, and the leaves a walk
// reaches at a bound are the ones the flat test passes at that bound.
// The bound only shrinks to the t of a hit already found, and a box
// entered at exactly the bound is still visited (tn <= bound), so a tie
// on a lower id is found.

#pragma once

#include <type_traits>

#include "pe_block.cuh"

namespace tpt {

constexpr int kWalkThreads = 256;
constexpr int kStack = 32;  // entries; clustered.TREE_MAX_DEPTH

struct Group {
  int lane;       // lane within the group
  unsigned mask;  // the group's lanes within the warp
  int slot;       // the group's index within the block
};

template <int G>
__device__ __forceinline__ Group group_of_thread() {
  static_assert(G == 4 || G == 8 || G == 16 || G == 32,
                "a group is a power-of-two part of a warp");
  const int lane = threadIdx.x & 31;
  const int lg = lane & (G - 1);
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (lane - lg);
  return Group{lg, mask, (int)threadIdx.x / G};
}

// The ray of thread threadIdx.x of block blockIdx.x in a walk launch of
// G lanes a ray.
template <int G>
__device__ __forceinline__ int walk_ray() {
  return (int)((blockIdx.x * (size_t)kWalkThreads + threadIdx.x) / G);
}

struct ClusterTree {
  const float4* __restrict__ bx;  // leaves [C, 8]
  const float4* __restrict__ nd;  // nodes [C - 1, 8]
  int n_boxes;
  float m;  // the ray's margin

  __device__ __forceinline__ int root() const { return n_boxes > 1 ? 0 : 1; }

  // The box of reference `ref`: leaf ref >> 1 when ref is odd, else node
  // ref >> 1 (two float4 loads either way).
  __device__ __forceinline__ bool enter(const Ray& r, const Slab& s,
                                        float tmin, int ref,
                                        float* tn) const {
    const float4* p = (ref & 1 ? bx : nd) + 2 * (size_t)(ref >> 1);
    return slab_enter(r, s, __ldg(p), __ldg(p + 1), m, tmin, tn);
  }

  __device__ __forceinline__ int2 kids(int node) const {
    const float4 links = __ldg(nd + 2 * (size_t)node + 1);
    return make_int2(__float_as_int(links.z), __float_as_int(links.w));
  }
};

struct InstanceTree {
  const float4* __restrict__ bx;  // leaves [I, 8]
  const float4* __restrict__ nd;  // nodes [n - 1, 12]
  int root_ref;                   // node 0, or the only real instance
  float omax;                     // max_k |o_k| of the world ray

  __device__ __forceinline__ int root() const { return root_ref; }

  __device__ __forceinline__ bool enter(const Ray& r, const Slab& s,
                                        float tmin, int ref,
                                        float* tn) const {
    const float4* p = ref & 1 ? bx + 2 * (size_t)(ref >> 1)
                              : nd + 3 * (size_t)(ref >> 1);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    return slab_enter(r, s, a, b, b.z * omax + b.w, tmin, tn);
  }

  __device__ __forceinline__ int2 kids(int node) const {
    const float4 links = __ldg(nd + 3 * (size_t)node + 2);
    return make_int2(__float_as_int(links.x), __float_as_int(links.y));
  }
};

// Walk `tree` for one ray, near first, calling leaf(index, &bound) on each
// leaf whose grown box the ray enters within (tmin, bound]; leaf may lower
// the bound and returns true to stop the walk.
template <class Tree, class Leaf>
__device__ __forceinline__ void walk_tree(const Ray& r, const Slab& s,
                                          float tmin, float bound,
                                          const Tree& tree, const Group& g,
                                          int* s_ref, float* s_tn,
                                          Leaf leaf) {
  int cur = tree.root();
  float tn;
  if (!(tree.enter(r, s, tmin, cur, &tn) && tn <= bound)) return;
  int sp = 0;
  for (;;) {
    if (cur & 1) {
      if (leaf(cur >> 1, &bound)) return;
    } else {
      const int2 kid = tree.kids(cur >> 1);
      float tn0, tn1;
      const bool p0 = tree.enter(r, s, tmin, kid.x, &tn0) && tn0 <= bound;
      const bool p1 = tree.enter(r, s, tmin, kid.y, &tn1) && tn1 <= bound;
      if (p0 && p1) {
        const bool first = tn0 <= tn1;  // the nearer; the lower on a tie
        // The group shares the stack: every lane has read the entry below
        // before lane 0 overwrites it, and sees the new one after.
        __syncwarp(g.mask);
        if (g.lane == 0) {
          s_ref[sp] = first ? kid.y : kid.x;
          s_tn[sp] = first ? tn1 : tn0;
        }
        __syncwarp(g.mask);
        ++sp;
        cur = first ? kid.x : kid.y;
        continue;
      }
      if (p0 || p1) {
        cur = p0 ? kid.x : kid.y;
        continue;
      }
    }
    // Pop the most recent entry that still enters within the bound.
    for (;;) {
      if (sp == 0) return;
      --sp;
      if (s_tn[sp] <= bound) {
        cur = s_ref[sp];
        break;
      }
    }
  }
}

// Any-hit leaf sweep of one cluster: the group's lanes split its rows
// (every G-th row a lane), skip refractive rows, and vote with one ballot.
// True when a row is hit with tmin < t < tm.
__device__ __forceinline__ bool cluster_blocked(
    const Ray& r, const float4* __restrict__ rows, int base, int cluster,
    int group, const Group& g, float tmin, float tm) {
  bool hit = false;
  for (int j = g.lane; j < cluster && !hit; j += group) {
    const float4* p = rows + 4 * (size_t)(base + j);
    if (!(__ldg(p + 3).y < 0.5f)) continue;  // refractive rows pass light
    hit = pe_test(r, __ldg(p), __ldg(p + 1), __ldg(p + 2), tmin) < tm;
  }
  // Other groups of the warp may reach the same ballot: keep this group's
  // bits only.
  return (__ballot_sync(g.mask, hit) & g.mask) != 0;
}

inline unsigned walk_grid(int n_rays, int group) {
  const size_t threads = (size_t)n_rays * group;
  return (unsigned)((threads + kWalkThreads - 1) / kWalkThreads);
}

// Calls launch(std::integral_constant<int, G>) for G = group, one of the
// widths built here (4, 8, 16, 32 lanes a ray); false for any other.
template <class Launch>
bool with_group(int group, Launch launch) {
  switch (group) {
    case 4: launch(std::integral_constant<int, 4>()); return true;
    case 8: launch(std::integral_constant<int, 8>()); return true;
    case 16: launch(std::integral_constant<int, 16>()); return true;
    case 32: launch(std::integral_constant<int, 32>()); return true;
    default: return false;
  }
}

}  // namespace tpt
