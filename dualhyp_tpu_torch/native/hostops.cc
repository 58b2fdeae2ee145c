// Host-side native ops for dualhyp_tpu_torch (a copy of the JAX package's
// dualhyp_tpu/native/hostops.cc).
//
// The card does the model math; these are the hot *host* loops:
//   - batched word-level Levenshtein distance (WER evaluation over large
//     prediction sets; replaces per-pair python DP, protocol parity with
//     inference/ger.py:96-117 of the reference)
//   - DTW alignment over a cost matrix (equivalent of the reference's
//     Triton dtw_kernel, data/whisper/triton_ops.py:13-41, used for
//     word-level timing)
//   - 1-D median filter (equivalent of the Triton median_kernel)
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Levenshtein distance between two int32 token sequences.
int32_t edit_distance(const int32_t* ref, int32_t ref_len,
                      const int32_t* hyp, int32_t hyp_len) {
  if (ref_len == 0) return hyp_len;
  if (hyp_len == 0) return ref_len;
  std::vector<int32_t> prev(hyp_len + 1), cur(hyp_len + 1);
  for (int32_t j = 0; j <= hyp_len; ++j) prev[j] = j;
  for (int32_t i = 1; i <= ref_len; ++i) {
    cur[0] = i;
    const int32_t r = ref[i - 1];
    for (int32_t j = 1; j <= hyp_len; ++j) {
      const int32_t sub = prev[j - 1] + (r != hyp[j - 1] ? 1 : 0);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[hyp_len];
}

// Batch edit distance over flattened sequences.
// refs/hyps: concatenated id arrays; *_offsets: n+1 prefix offsets.
// out: n distances.
void edit_distance_batch(const int32_t* refs, const int64_t* ref_offsets,
                         const int32_t* hyps, const int64_t* hyp_offsets,
                         int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t rl = static_cast<int32_t>(ref_offsets[i + 1] - ref_offsets[i]);
    const int32_t hl = static_cast<int32_t>(hyp_offsets[i + 1] - hyp_offsets[i]);
    out[i] = edit_distance(refs + ref_offsets[i], rl, hyps + hyp_offsets[i], hl);
  }
}

// DTW over an (n, m) cost matrix (row-major float32). Writes the backtraced
// alignment path indices into path_i / path_j (caller-allocated, capacity
// n+m) and returns the path length. Matches whisper's dtw semantics:
// monotonic steps {(1,0),(0,1),(1,1)}, accumulating cost, backtrace
// preferring the minimal predecessor.
int32_t dtw(const float* cost, int32_t n, int32_t m,
            int32_t* path_i, int32_t* path_j) {
  const float INF = 1e30f;
  std::vector<float> acc(static_cast<size_t>(n + 1) * (m + 1), INF);
  std::vector<int8_t> trace(static_cast<size_t>(n + 1) * (m + 1), 0);
  auto idx = [m](int32_t i, int32_t j) {
    return static_cast<size_t>(i) * (m + 1) + j;
  };
  acc[idx(0, 0)] = 0.0f;
  for (int32_t i = 1; i <= n; ++i) {
    for (int32_t j = 1; j <= m; ++j) {
      const float c0 = acc[idx(i - 1, j - 1)];  // diagonal
      const float c1 = acc[idx(i - 1, j)];      // up
      const float c2 = acc[idx(i, j - 1)];      // left
      float best = c0;
      int8_t t = 0;
      if (c1 < best) { best = c1; t = 1; }
      if (c2 < best) { best = c2; t = 2; }
      acc[idx(i, j)] = cost[static_cast<size_t>(i - 1) * m + (j - 1)] + best;
      trace[idx(i, j)] = t;
    }
  }
  // backtrace
  int32_t i = n, j = m, len = 0;
  std::vector<int32_t> pi, pj;
  while (i > 0 && j > 0) {
    pi.push_back(i - 1);
    pj.push_back(j - 1);
    const int8_t t = trace[idx(i, j)];
    if (t == 0) { --i; --j; }
    else if (t == 1) { --i; }
    else { --j; }
  }
  len = static_cast<int32_t>(pi.size());
  for (int32_t k = 0; k < len; ++k) {
    path_i[k] = pi[len - 1 - k];
    path_j[k] = pj[len - 1 - k];
  }
  return len;
}

// 1-D median filter with edge replication; width must be odd.
void median_filter(const float* x, int64_t n, int32_t width, float* out) {
  const int32_t half = width / 2;
  std::vector<float> window(width);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t k = -half; k <= half; ++k) {
      int64_t j = i + k;
      if (j < 0) j = 0;
      if (j >= n) j = n - 1;
      window[k + half] = x[j];
    }
    std::nth_element(window.begin(), window.begin() + half, window.end());
    out[i] = window[half];
  }
}

}  // extern "C"
