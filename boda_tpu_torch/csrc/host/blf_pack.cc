// Bottom-left-fill bin packing fast path (reference capability:
// blf_place, blf_pack.cc ~200-330 — multi-scale pyramid packing into
// fixed device-batch bins).
//
// Semantics-identical to boda_tpu_torch/apps/pyra.py blf_place(): rects sorted
// by descending area (stable by input index), candidate corners tried in
// (y, x) order, each placement reserves `pad` on its +y/+x sides, pad may
// hang off the bin edge but the image may not.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct P { int64_t y, x; };
struct B { P p0, p1; };

bool overlap(const B &a, const B &b) {
  return a.p0.y < b.p1.y && b.p0.y < a.p1.y && a.p0.x < b.p1.x && b.p0.x < a.p1.x;
}

}  // namespace

extern "C" {

// sizes: n pairs (y, x). out: n triples (bin_ix, y0, x0), caller-alloc'd.
// Returns number of bins used, or -1 if a rect exceeds the bin size.
int32_t boda_blf_place(const int64_t *sizes, int32_t n, int64_t bin_y,
                       int64_t bin_x, int64_t pad_y, int64_t pad_x,
                       int64_t *out) {
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return sizes[2 * a] * sizes[2 * a + 1] > sizes[2 * b] * sizes[2 * b + 1];
  });
  std::vector<std::vector<B>> bins;   // placed (padded, clipped) boxes
  std::vector<std::vector<P>> cands;  // candidate corners per bin

  auto fits = [&](size_t bi, P at, P sz) -> bool {
    if (at.y + sz.y + pad_y > bin_y + pad_y || at.x + sz.x + pad_x > bin_x + pad_x) {
      if (at.y + sz.y > bin_y || at.x + sz.x > bin_x) return false;
    }
    B clipped{at, {std::min(at.y + sz.y + pad_y, bin_y),
                   std::min(at.x + sz.x + pad_x, bin_x)}};
    for (const B &b : bins[bi])
      if (overlap(clipped, b)) return false;
    return true;
  };

  auto place = [&](size_t bi, P at, P sz, int32_t idx) {
    bins[bi].push_back(B{at, {std::min(at.y + sz.y + pad_y, bin_y),
                              std::min(at.x + sz.x + pad_x, bin_x)}});
    cands[bi].push_back(P{at.y + sz.y + pad_y, at.x});
    cands[bi].push_back(P{at.y, at.x + sz.x + pad_x});
    out[3 * idx] = (int64_t)bi;
    out[3 * idx + 1] = at.y;
    out[3 * idx + 2] = at.x;
  };

  for (int32_t oi = 0; oi < n; oi++) {
    int32_t idx = order[oi];
    P sz{sizes[2 * idx], sizes[2 * idx + 1]};
    if (sz.y > bin_y || sz.x > bin_x) return -1;
    bool placed = false;
    for (size_t bi = 0; bi < bins.size() && !placed; bi++) {
      std::vector<P> sorted_c = cands[bi];
      std::sort(sorted_c.begin(), sorted_c.end(), [](const P &a, const P &b) {
        return a.y != b.y ? a.y < b.y : a.x < b.x;
      });
      for (const P &at : sorted_c) {
        if (!fits(bi, at, sz)) continue;
        // remove the used candidate (first exact match)
        for (size_t k = 0; k < cands[bi].size(); k++)
          if (cands[bi][k].y == at.y && cands[bi][k].x == at.x) {
            cands[bi].erase(cands[bi].begin() + (long)k);
            break;
          }
        place(bi, at, sz, idx);
        placed = true;
        break;
      }
    }
    if (!placed) {
      bins.emplace_back();
      cands.push_back({});
      P at{0, 0};
      if (!fits(bins.size() - 1, at, sz)) return -1;
      place(bins.size() - 1, at, sz, idx);
    }
  }
  return (int32_t)bins.size();
}

}  // extern "C"
