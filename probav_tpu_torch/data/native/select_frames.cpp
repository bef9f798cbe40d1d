// Native host-runtime kernel: stage-4 frame-replacement selection.
//
// Reproduces removeAndReplaceDirtyFrames (reference utils/dataGenerator.py:
// 362-409) as pure index logic over precomputed per-frame occlusion counts:
// keep frames under the occlusion limit (original order), fall back to all
// frames when none survive, tile ceil(k/len) copies, stable-sort the tiled
// list by occlusion, emit the first k indices.  The Python pipeline does one
// vectorized occlusion pass and a single gather around this.
//
// Built as a plain C ABI shared object with g++ at first use and loaded
// via ctypes by probav_tpu_torch/data/_native.py; a failed build raises.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int probav_select_frames(
    const int64_t* occ,   // [S * P * T] occluded-pixel counts
    int64_t s, int64_t p, int64_t t,
    int64_t k,
    double limit,         // occlusion-count limit: (1 - threshold) * H * W
    int32_t* out_idx,     // [S * P * k] selected frame indices
    int64_t* stats        // [2]: num_dirty, num_unreplaced
) {
    if (s < 0 || p < 0 || t <= 0 || k <= 0) return 1;
    int64_t dirty = 0, unreplaced = 0;
    std::vector<int32_t> good;
    std::vector<int32_t> tiled;
    good.reserve(t);
    tiled.reserve(static_cast<size_t>(k + t));

    const int64_t n_patches = s * p;
    for (int64_t n = 0; n < n_patches; ++n) {
        const int64_t* o = occ + n * t;
        good.clear();
        for (int64_t ti = 0; ti < t; ++ti) {
            if (static_cast<double>(o[ti]) < limit) {
                good.push_back(static_cast<int32_t>(ti));
            }
        }
        if (good.empty()) {
            for (int64_t ti = 0; ti < t; ++ti)
                good.push_back(static_cast<int32_t>(ti));
            dirty += t;
            unreplaced += t;
        } else {
            dirty += t - static_cast<int64_t>(good.size());
        }
        const int64_t copies = (k + static_cast<int64_t>(good.size()) - 1)
                               / static_cast<int64_t>(good.size());
        tiled.clear();
        for (int64_t c = 0; c < copies; ++c) {
            tiled.insert(tiled.end(), good.begin(), good.end());
        }
        std::stable_sort(tiled.begin(), tiled.end(),
                         [o](int32_t a, int32_t b) { return o[a] < o[b]; });
        int32_t* out = out_idx + n * k;
        for (int64_t i = 0; i < k; ++i) out[i] = tiled[i];
    }
    stats[0] = dirty;
    stats[1] = unreplaced;
    return 0;
}
