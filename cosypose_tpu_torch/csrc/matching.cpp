// Host-side combinatorics for multi-view candidate matching.
//
// The PyTorch port's own copy of cosypose_tpu/csrc/matching.cpp, code
// unchanged, so both packages enumerate the same tentative matches, draw the
// same RANSAC seeds (std::default_random_engine + std::shuffle) and run the
// same greedy unique inlier pass. The equivalent of the reference's
// cosypose_cext (cosypose/csrc/cosypose_cext.cpp:264-269, four entry points):
// the data-dependent enumeration stays on the host in C++, emitting flat
// index arrays that the scoring on the device consumes. Exposed through a
// plain C ABI (handle + getter pattern) for ctypes
// (cosypose_tpu_torch/multiview/matching_cext.py builds it with g++).
//
// Differences from the reference interface:
//   * labels are int32 codes, not strings (mesh-database object ids).
//   * scatter_argmin / expand_ids_for_symmetry exist for API parity; the
//     main path does not use them (symmetry reductions are masked minima on
//     the device).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <numeric>
#include <random>
#include <set>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

struct Match {
  int32_t c1, c2;
};

struct RansacInfos {
  std::vector<int32_t> seed_view1, seed_view2;
  std::vector<int32_t> seed_m1c1, seed_m1c2, seed_m2c1, seed_m2c2;
  std::vector<int32_t> mtc_hyp, mtc_c1, mtc_c2;
};

struct InlierResult {
  std::vector<int32_t> inlier_c1, inlier_c2;
  std::vector<int32_t> best_hypotheses;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// make_ransac_infos: enumerate tentative same-label cross-view matches, sample
// up to n_ransac_iter seed match-pairs per (view1, view2) pair, and emit the
// hypothesis-expanded tentative match list.
// ---------------------------------------------------------------------------
void* make_ransac_infos(const int32_t* view_ids, const int32_t* label_ids,
                        int64_t n_cand, int32_t n_ransac_iter, int32_t seed) {
  using ViewPair = std::pair<int32_t, int32_t>;
  std::map<ViewPair, std::vector<Match>> tentative;
  for (int64_t n = 0; n < n_cand; n++) {
    for (int64_t m = 0; m < n_cand; m++) {
      if (view_ids[n] != view_ids[m] && label_ids[n] == label_ids[m]) {
        tentative[{view_ids[n], view_ids[m]}].push_back(
            {static_cast<int32_t>(n), static_cast<int32_t>(m)});
      }
    }
  }

  auto* out = new RansacInfos();
  int32_t n_seeds = 0;
  for (auto& kv : tentative) {
    const auto& matches = kv.second;
    const int n_matches = static_cast<int>(matches.size());
    std::vector<int> perm1(n_matches), perm2(n_matches);
    std::iota(perm1.begin(), perm1.end(), 0);
    std::iota(perm2.begin(), perm2.end(), 0);
    std::shuffle(perm1.begin(), perm1.end(), std::default_random_engine(seed));
    std::shuffle(perm2.begin(), perm2.end(),
                 std::default_random_engine(seed + 1));
    int n_pairs = 0;
    for (int m1 : perm1) {
      if (n_pairs >= n_ransac_iter) break;
      for (int m2 : perm2) {
        if (n_pairs >= n_ransac_iter) break;
        if (m1 == m2) continue;
        out->seed_view1.push_back(kv.first.first);
        out->seed_view2.push_back(kv.first.second);
        out->seed_m1c1.push_back(matches[m1].c1);
        out->seed_m1c2.push_back(matches[m1].c2);
        out->seed_m2c1.push_back(matches[m2].c1);
        out->seed_m2c2.push_back(matches[m2].c2);
        for (const auto& t : matches) {
          out->mtc_hyp.push_back(n_seeds);
          out->mtc_c1.push_back(t.c1);
          out->mtc_c2.push_back(t.c2);
        }
        n_pairs++;
        n_seeds++;
      }
    }
  }
  return out;
}

int64_t ransac_infos_n_seeds(void* h) {
  return static_cast<RansacInfos*>(h)->seed_view1.size();
}
int64_t ransac_infos_n_tmatches(void* h) {
  return static_cast<RansacInfos*>(h)->mtc_hyp.size();
}
void ransac_infos_fill(void* h, int32_t* seeds /* (n_seeds, 6) */,
                       int32_t* tmatches /* (n_tmatches, 3) */) {
  auto* r = static_cast<RansacInfos*>(h);
  const int64_t ns = r->seed_view1.size();
  for (int64_t i = 0; i < ns; i++) {
    seeds[i * 6 + 0] = r->seed_view1[i];
    seeds[i * 6 + 1] = r->seed_view2[i];
    seeds[i * 6 + 2] = r->seed_m1c1[i];
    seeds[i * 6 + 3] = r->seed_m1c2[i];
    seeds[i * 6 + 4] = r->seed_m2c1[i];
    seeds[i * 6 + 5] = r->seed_m2c2[i];
  }
  const int64_t nt = r->mtc_hyp.size();
  for (int64_t i = 0; i < nt; i++) {
    tmatches[i * 3 + 0] = r->mtc_hyp[i];
    tmatches[i * 3 + 1] = r->mtc_c1[i];
    tmatches[i * 3 + 2] = r->mtc_c2[i];
  }
}
void ransac_infos_free(void* h) { delete static_cast<RansacInfos*>(h); }

// ---------------------------------------------------------------------------
// find_ransac_inliers: per hypothesis, threshold distances, greedily 1-1 match
// candidates by ascending distance, pick the best hypothesis per view pair by
// (n_inliers, sum of dists).
// ---------------------------------------------------------------------------
void* find_ransac_inliers(const int32_t* seeds_view1,
                          const int32_t* seeds_view2, int64_t n_hyp,
                          const int32_t* mtc_hyp, const int32_t* mtc_c1,
                          const int32_t* mtc_c2, const float* dists,
                          int64_t n_mtc, float dist_threshold,
                          int32_t n_min_inliers) {
  struct Hyp {
    int32_t view1 = 0, view2 = 0;
    std::vector<Match> inliers;
    std::vector<float> inlier_dists;
    std::vector<Match> uniq;
    float dists_sum = 0.f;
    int n_inliers = 0;
  };
  using ViewPair = std::pair<int32_t, int32_t>;

  std::vector<Hyp> hyps(n_hyp);
  std::map<ViewPair, std::vector<int64_t>> by_pair;
  for (int64_t n = 0; n < n_hyp; n++) {
    hyps[n].view1 = seeds_view1[n];
    hyps[n].view2 = seeds_view2[n];
    by_pair[{seeds_view1[n], seeds_view2[n]}].push_back(n);
  }
  for (int64_t n = 0; n < n_mtc; n++) {
    if (dists[n] <= dist_threshold) {
      Hyp& h = hyps[mtc_hyp[n]];
      h.inliers.push_back({mtc_c1[n], mtc_c2[n]});
      h.inlier_dists.push_back(dists[n]);
    }
  }
  // greedy unique matching by ascending distance (stable)
  for (auto& h : hyps) {
    std::vector<int> order(h.inliers.size());
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return h.inlier_dists[a] < h.inlier_dists[b];
    });
    std::set<int32_t> used1, used2;
    for (int i : order) {
      const Match& m = h.inliers[i];
      if (!used1.count(m.c1) && !used2.count(m.c2)) {
        used1.insert(m.c1);
        used2.insert(m.c2);
        h.uniq.push_back(m);
        h.dists_sum += h.inlier_dists[i];
        h.n_inliers++;
      }
    }
  }

  auto* out = new InlierResult();
  for (auto& kv : by_pair) {
    int64_t best_id = -1;
    float best_sum = std::numeric_limits<float>::max();
    int best_n = 0;
    for (int64_t id : kv.second) {
      const Hyp& h = hyps[id];
      if (h.n_inliers >= n_min_inliers &&
          (h.n_inliers > best_n ||
           (h.n_inliers == best_n && h.dists_sum < best_sum))) {
        best_id = id;
        best_n = h.n_inliers;
        best_sum = h.dists_sum;
      }
    }
    // NOTE: the reference keeps a best hypothesis only when its id is > 0
    // (ref: cosypose_cext.cpp:205 `best_hypothesis.hypothesis_id > 0`), which
    // silently drops hypothesis 0 — we use >= 0 (the reference behavior looks
    // like an off-by-one; hypothesis 0 is as valid as any other).
    if (best_id >= 0) {
      out->best_hypotheses.push_back(static_cast<int32_t>(best_id));
      for (const auto& m : hyps[best_id].uniq) {
        out->inlier_c1.push_back(m.c1);
        out->inlier_c2.push_back(m.c2);
      }
    }
  }
  return out;
}

int64_t inliers_n_matches(void* h) {
  return static_cast<InlierResult*>(h)->inlier_c1.size();
}
int64_t inliers_n_best(void* h) {
  return static_cast<InlierResult*>(h)->best_hypotheses.size();
}
void inliers_fill(void* h, int32_t* matches /* (n, 2) */, int32_t* best) {
  auto* r = static_cast<InlierResult*>(h);
  for (size_t i = 0; i < r->inlier_c1.size(); i++) {
    matches[i * 2 + 0] = r->inlier_c1[i];
    matches[i * 2 + 1] = r->inlier_c2[i];
  }
  std::memcpy(best, r->best_hypotheses.data(),
              r->best_hypotheses.size() * sizeof(int32_t));
}
void inliers_free(void* h) { delete static_cast<InlierResult*>(h); }

// ---------------------------------------------------------------------------
// scatter_argmin: argmin of values within each segment id (API parity;
// device code uses masked minima instead).
// ---------------------------------------------------------------------------
void scatter_argmin(const float* values, const int32_t* segment_ids, int64_t n,
                    int32_t* out /* size n_segments */, int64_t n_segments) {
  std::vector<float> best(n_segments, std::numeric_limits<float>::max());
  for (int64_t i = 0; i < n_segments; i++) out[i] = -1;
  for (int64_t i = 0; i < n; i++) {
    const int32_t s = segment_ids[i];
    if (out[s] < 0 || values[i] < best[s]) {
      best[s] = values[i];
      out[s] = static_cast<int32_t>(i);
    }
  }
}

// ---------------------------------------------------------------------------
// expand_ids_for_symmetry: repeat row n n_sym[label_ids[n]] times with
// per-repeat symmetry ids (API parity).
// ---------------------------------------------------------------------------
int64_t expand_ids_for_symmetry_size(const int32_t* label_ids,
                                     const int32_t* n_sym_per_label,
                                     int64_t n) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; i++) total += n_sym_per_label[label_ids[i]];
  return total;
}
void expand_ids_for_symmetry(const int32_t* label_ids,
                             const int32_t* n_sym_per_label, int64_t n,
                             int32_t* ids_expand, int32_t* sym_ids) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; i++) {
    for (int32_t s = 0; s < n_sym_per_label[label_ids[i]]; s++) {
      ids_expand[k] = static_cast<int32_t>(i);
      sym_ids[k] = s;
      k++;
    }
  }
}

}  // extern "C"
