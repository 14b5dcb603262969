// Native binned-SAH BVH builder for nanort_tpu_torch: the port's own copy
// of the JAX package's nanort_tpu/native/sah_builder.cc with its code
// unchanged, so that both packages build identical trees.
//
// Same algorithm as build/sah.py (see that file's docstring for
// the relation to the reference builder, nanort.h:1759-1890): 3-axis binned
// SAH with centroid quantization, object-median fallback, DFS-preorder node
// emission (left child == parent + 1), and a max-leaf-size cap.
//
// Parallelization follows the reference's two-phase scheme
// (nanort.h:1600-1757, 1997-2073) re-derived for this builder: the top of
// the tree is built serially until enough independent subtree tasks exist,
// then a thread pool builds each subtree into thread-local buffers which are
// spliced back with child-index fixup.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread sah_builder.cc -o libsah.so

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface_area(const V3 &lo, const V3 &hi) {
  float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}
static inline float comp(const V3 &v, int ax) {
  return ax == 0 ? v.x : (ax == 1 ? v.y : v.z);
}

struct Node {
  float bmin[3];
  float bmax[3];
  int32_t flag;  // 1 leaf, 0 branch
  int32_t axis;
  uint32_t data[2];
};

struct Options {
  int min_leaf;
  int max_leaf;
  int max_depth;
  int bin_size;  // <= 256
};

struct Stats {
  int max_depth = 0;
  int64_t leaves = 0;
  int64_t branches = 0;
};

struct Builder {
  const V3 *bmin;
  const V3 *bmax;
  const V3 *center;
  uint32_t *indices;
  Options opt;

  void range_bounds(int64_t l, int64_t r, V3 *lo, V3 *hi) const {
    V3 a = bmin[indices[l]], b = bmax[indices[l]];
    for (int64_t i = l + 1; i < r; i++) {
      a = vmin(a, bmin[indices[i]]);
      b = vmax(b, bmax[indices[i]]);
    }
    *lo = a;
    *hi = b;
  }

  // Binned SAH over all 3 axes; returns best axis and fills cut positions.
  int find_cut(int64_t l, int64_t r, const V3 &lo, const V3 &hi,
               float cut_pos[3]) const {
    const int B = opt.bin_size;
    // per-axis bins: count + bbox
    std::vector<int64_t> cnt(3 * B, 0);
    std::vector<V3> blo(3 * B, V3{FLT_MAX, FLT_MAX, FLT_MAX});
    std::vector<V3> bhi(3 * B, V3{-FLT_MAX, -FLT_MAX, -FLT_MAX});
    float ext[3] = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
    float inv[3];
    for (int a = 0; a < 3; a++)
      inv[a] = ext[a] > 0.0f ? (float)B / ext[a] : 0.0f;

    for (int64_t i = l; i < r; i++) {
      uint32_t p = indices[i];
      const V3 &c = center[p];
      float q[3] = {(c.x - lo.x) * inv[0], (c.y - lo.y) * inv[1],
                    (c.z - lo.z) * inv[2]};
      for (int a = 0; a < 3; a++) {
        int bi = (int)q[a];
        bi = bi < 0 ? 0 : (bi >= B ? B - 1 : bi);
        int k = a * B + bi;
        cnt[k]++;
        blo[k] = vmin(blo[k], bmin[p]);
        bhi[k] = vmax(bhi[k], bmax[p]);
      }
    }

    float best_cost[3];
    int best_bin[3];
    for (int a = 0; a < 3; a++) {
      // suffix sweep
      std::vector<float> suf_sa(B + 1, 0.0f);
      std::vector<int64_t> suf_cnt(B + 1, 0);
      V3 slo{FLT_MAX, FLT_MAX, FLT_MAX}, shi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int64_t sc = 0;
      for (int b = B - 1; b >= 0; b--) {
        int k = a * B + b;
        if (cnt[k]) {
          slo = vmin(slo, blo[k]);
          shi = vmax(shi, bhi[k]);
          sc += cnt[k];
        }
        suf_cnt[b] = sc;
        suf_sa[b] = sc ? surface_area(slo, shi) : 0.0f;
      }
      // prefix sweep picking min cost
      V3 plo{FLT_MAX, FLT_MAX, FLT_MAX}, phi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int64_t pc = 0;
      best_cost[a] = FLT_MAX;
      best_bin[a] = 1;
      for (int b = 0; b < B - 1; b++) {
        int k = a * B + b;
        if (cnt[k]) {
          plo = vmin(plo, blo[k]);
          phi = vmax(phi, bhi[k]);
          pc += cnt[k];
        }
        int64_t rc = suf_cnt[b + 1];
        if (pc == 0 || rc == 0) continue;
        float cost = pc * surface_area(plo, phi) + rc * suf_sa[b + 1];
        if (cost < best_cost[a]) {
          best_cost[a] = cost;
          best_bin[a] = b + 1;
        }
      }
      cut_pos[a] = comp(lo, a) + best_bin[a] * (ext[a] / B);
    }
    int axis = 0;
    if (best_cost[1] < best_cost[axis]) axis = 1;
    if (best_cost[2] < best_cost[axis]) axis = 2;
    if (best_cost[axis] == FLT_MAX) {
      // all degenerate: pick largest extent (median fallback will split)
      axis = ext[1] > ext[0] ? 1 : 0;
      if (ext[2] > ext[axis]) axis = 2;
    }
    return axis;
  }

  // Recursive preorder build into `nodes`. Returns node offset.
  uint32_t build_tree(std::vector<Node> *nodes, Stats *st, int64_t l,
                      int64_t r, int depth) {
    uint32_t offset = (uint32_t)nodes->size();
    if (depth > st->max_depth) st->max_depth = depth;

    V3 lo, hi;
    range_bounds(l, r, &lo, &hi);
    int64_t n = r - l;

    bool leaf = n <= opt.min_leaf ||
                (depth >= opt.max_depth && n <= opt.max_leaf);
    if (leaf) {
      Node nd;
      std::memcpy(nd.bmin, &lo, 12);
      std::memcpy(nd.bmax, &hi, 12);
      nd.flag = 1;
      nd.axis = 0;
      nd.data[0] = (uint32_t)n;
      nd.data[1] = (uint32_t)l;
      nodes->push_back(nd);
      st->leaves++;
      return offset;
    }

    float cut_pos[3];
    int min_axis = find_cut(l, r, lo, hi, cut_pos);

    // 3-axis retry with median fallback (reference nanort.h:1827-1857)
    int64_t mid = l;
    int axis = min_axis;
    bool ok = false;
    for (int t = 0; t < 3; t++) {
      axis = (min_axis + t) % 3;
      float pos = cut_pos[axis];
      uint32_t *first = indices + l;
      uint32_t *last = indices + r;
      uint32_t *m = std::partition(first, last, [&](uint32_t i) {
        return comp(center[i], axis) < pos;
      });
      mid = l + (m - first);
      if (mid != l && mid != r) {
        ok = true;
        break;
      }
    }
    if (!ok) {
      axis = min_axis;
      mid = l + (n >> 1);
      std::nth_element(indices + l, indices + mid, indices + r,
                       [&](uint32_t a, uint32_t b) {
                         return comp(center[a], axis) < comp(center[b], axis);
                       });
    }

    Node nd;
    std::memcpy(nd.bmin, &lo, 12);
    std::memcpy(nd.bmax, &hi, 12);
    nd.flag = 0;
    nd.axis = axis;
    nodes->push_back(nd);
    st->branches++;

    uint32_t lidx = build_tree(nodes, st, l, mid, depth + 1);
    uint32_t ridx = build_tree(nodes, st, mid, r, depth + 1);
    (*nodes)[offset].data[0] = lidx;
    (*nodes)[offset].data[1] = ridx;
    return offset;
  }
};

struct ShallowTask {
  int64_t l, r;
  int depth;
  uint32_t placeholder;  // node slot to replace with subtree root
};

}  // namespace

extern "C" {

// Returns 0 on success. Output arrays must have capacity:
//   nodes: 2*n_prims entries; indices_out: n_prims.
int nanort_tpu_build_sah(const float *prim_bmin, const float *prim_bmax,
                         const float *prim_center, int64_t n_prims,
                         int min_leaf, int max_leaf, int max_depth,
                         int bin_size, int shallow_depth, int n_threads,
                         float *node_bmin_out, float *node_bmax_out,
                         int32_t *node_flag_out, int32_t *node_axis_out,
                         uint32_t *node_data_out, uint32_t *indices_out,
                         int64_t *out_num_nodes, int64_t *out_stats) {
  if (n_prims <= 0) return 1;
  if (bin_size < 2 || bin_size > 1024) return 2;

  std::vector<uint32_t> indices(n_prims);
  for (int64_t i = 0; i < n_prims; i++) indices[i] = (uint32_t)i;

  Builder bld;
  bld.bmin = reinterpret_cast<const V3 *>(prim_bmin);
  bld.bmax = reinterpret_cast<const V3 *>(prim_bmax);
  bld.center = reinterpret_cast<const V3 *>(prim_center);
  bld.indices = indices.data();
  bld.opt = Options{min_leaf, max_leaf, max_depth, bin_size};

  std::vector<Node> nodes;
  nodes.reserve((size_t)(2 * n_prims));
  Stats st;

  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, 256));

  // Phase 1: serial top-of-tree to `shallow_depth`, collecting deferred
  // subtree tasks with placeholder nodes.
  std::vector<ShallowTask> tasks;
  struct Item {
    int64_t l, r;
    int depth;
    int64_t parent;  // node slot to patch
    int child_pos;
  };
  const bool parallel = n_threads > 1 && n_prims > 8192;
  std::vector<Item> stack{{0, n_prims, 0, -1, 0}};
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    uint32_t slot = (uint32_t)nodes.size();
    if (it.parent >= 0) nodes[it.parent].data[it.child_pos] = slot;

    if (!parallel || it.depth >= shallow_depth) {
      // leave the whole subtree as a task (placeholder node emitted)
      Node ph{};
      ph.flag = -1;
      nodes.push_back(ph);
      tasks.push_back(ShallowTask{it.l, it.r, it.depth, slot});
      continue;
    }
    if (it.depth > st.max_depth) st.max_depth = it.depth;

    V3 lo, hi;
    bld.range_bounds(it.l, it.r, &lo, &hi);
    int64_t n = it.r - it.l;
    if (n <= bld.opt.min_leaf) {
      Node nd;
      std::memcpy(nd.bmin, &lo, 12);
      std::memcpy(nd.bmax, &hi, 12);
      nd.flag = 1;
      nd.axis = 0;
      nd.data[0] = (uint32_t)n;
      nd.data[1] = (uint32_t)it.l;
      nodes.push_back(nd);
      st.leaves++;
      continue;
    }
    float cut_pos[3];
    int min_axis = bld.find_cut(it.l, it.r, lo, hi, cut_pos);
    int64_t mid = it.l;
    int axis = min_axis;
    bool ok = false;
    for (int t = 0; t < 3; t++) {
      axis = (min_axis + t) % 3;
      float pos = cut_pos[axis];
      uint32_t *m = std::partition(
          indices.data() + it.l, indices.data() + it.r,
          [&](uint32_t i) { return comp(bld.center[i], axis) < pos; });
      mid = m - indices.data();
      if (mid != it.l && mid != it.r) {
        ok = true;
        break;
      }
    }
    if (!ok) {
      axis = min_axis;
      mid = it.l + (n >> 1);
      std::nth_element(indices.data() + it.l, indices.data() + mid,
                       indices.data() + it.r, [&](uint32_t a, uint32_t b) {
                         return comp(bld.center[a], axis) <
                                comp(bld.center[b], axis);
                       });
    }
    Node nd;
    std::memcpy(nd.bmin, &lo, 12);
    std::memcpy(nd.bmax, &hi, 12);
    nd.flag = 0;
    nd.axis = axis;
    int64_t slot_i = (int64_t)nodes.size();
    nodes.push_back(nd);
    st.branches++;
    // push right then left so left is processed first (preorder-ish; child
    // indices are patched explicitly so exact order is not load-bearing)
    stack.push_back(Item{mid, it.r, it.depth + 1, slot_i, 1});
    stack.push_back(Item{it.l, mid, it.depth + 1, slot_i, 0});
  }

  // Phase 2: build each deferred subtree in parallel.
  std::vector<std::vector<Node>> sub_nodes(tasks.size());
  std::vector<Stats> sub_stats(tasks.size());
  {
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        size_t k = next.fetch_add(1);
        if (k >= tasks.size()) break;
        const ShallowTask &t = tasks[k];
        sub_nodes[k].reserve((size_t)(2 * (t.r - t.l)));
        Builder local = bld;  // shares indices (disjoint ranges)
        local.build_tree(&sub_nodes[k], &sub_stats[k], t.l, t.r, t.depth);
      }
    };
    if (tasks.size() <= 1 || n_threads == 1) {
      worker();
    } else {
      std::vector<std::thread> pool;
      int tcount = std::min<int>(n_threads, (int)tasks.size());
      for (int i = 0; i < tcount; i++) pool.emplace_back(worker);
      for (auto &th : pool) th.join();
    }
  }

  // Phase 3: splice subtrees, replacing placeholders and offsetting child
  // indices (cf. reference splice, nanort.h:2040-2067).
  // Compute final offsets: placeholders are replaced in-place by the
  // subtree root; the rest of each subtree appends at the end.
  size_t total = nodes.size();
  std::vector<size_t> tail_base(tasks.size());
  for (size_t k = 0; k < tasks.size(); k++) {
    tail_base[k] = total;
    total += sub_nodes[k].size() > 0 ? sub_nodes[k].size() - 1 : 0;
  }
  if (total > (size_t)(2 * n_prims)) return 3;

  nodes.resize(total);
  for (size_t k = 0; k < tasks.size(); k++) {
    const auto &sn = sub_nodes[k];
    if (sn.empty()) continue;
    uint32_t ph = tasks[k].placeholder;
    size_t base = tail_base[k];
    // subtree-local index -> global: 0 -> ph; i>0 -> base + i - 1
    auto remap = [&](uint32_t i) -> uint32_t {
      return i == 0 ? ph : (uint32_t)(base + i - 1);
    };
    for (size_t i = 0; i < sn.size(); i++) {
      Node nd = sn[i];
      if (nd.flag == 0) {
        nd.data[0] = remap(nd.data[0]);
        nd.data[1] = remap(nd.data[1]);
      }
      nodes[remap((uint32_t)i)] = nd;
    }
    st.max_depth = std::max(st.max_depth, sub_stats[k].max_depth);
    st.leaves += sub_stats[k].leaves;
    st.branches += sub_stats[k].branches;
  }

  // Emit SoA outputs in DFS preorder (left child == parent + 1), the
  // invariant the reference's recursive builder provides and the skip-link
  // wavefront traversal relies on; the splice above broke it.
  size_t nn = nodes.size();
  {
    struct Visit {
      uint32_t src;
      int64_t parent_out;
      int child_pos;
    };
    std::vector<Visit> vs;
    vs.push_back(Visit{0, -1, 0});
    size_t out_i = 0;
    while (!vs.empty()) {
      Visit v = vs.back();
      vs.pop_back();
      const Node &nd = nodes[v.src];
      size_t i = out_i++;
      if (v.parent_out >= 0) node_data_out[2 * v.parent_out + v.child_pos] = (uint32_t)i;
      std::memcpy(node_bmin_out + 3 * i, nd.bmin, 12);
      std::memcpy(node_bmax_out + 3 * i, nd.bmax, 12);
      node_flag_out[i] = nd.flag;
      node_axis_out[i] = nd.axis;
      if (nd.flag == 1) {
        node_data_out[2 * i] = nd.data[0];
        node_data_out[2 * i + 1] = nd.data[1];
      } else {
        vs.push_back(Visit{nd.data[1], (int64_t)i, 1});
        vs.push_back(Visit{nd.data[0], (int64_t)i, 0});
      }
    }
    if (out_i != nn) return 4;
  }
  std::memcpy(indices_out, indices.data(), sizeof(uint32_t) * n_prims);
  *out_num_nodes = (int64_t)nn;
  out_stats[0] = st.max_depth;
  out_stats[1] = st.leaves;
  out_stats[2] = st.branches;
  return 0;
}

// Per-face triangle bounds + centroids (the hot pre-pass feeding the
// builder): vertices (v_count,3) f32, faces (f_count,3) i32.
void nanort_tpu_triangle_bounds(const float *vertices, const int32_t *faces,
                                int64_t f_count, float *bmin_out,
                                float *bmax_out, float *center_out) {
  for (int64_t i = 0; i < f_count; i++) {
    const float *p0 = vertices + 3 * faces[3 * i];
    const float *p1 = vertices + 3 * faces[3 * i + 1];
    const float *p2 = vertices + 3 * faces[3 * i + 2];
    for (int a = 0; a < 3; a++) {
      float lo = std::min(p0[a], std::min(p1[a], p2[a]));
      float hi = std::max(p0[a], std::max(p1[a], p2[a]));
      bmin_out[3 * i + a] = lo;
      bmax_out[3 * i + a] = hi;
      center_out[3 * i + a] = (p0[a] + p1[a] + p2[a]) / 3.0f;
    }
  }
}

}  // extern "C"
