// Fast text-metric kernels for batch evaluation throughput.
//
// The scoring oracle (CER/WER over whole page sets, eval_final batch mode)
// is O(n*m) dynamic programming per pair; this C++ engine provides the hot
// inner loops behind ctypes bindings (handwritten_ocr_tpu_torch/native/
// __init__.py), bit-identical to the NumPy row engines in text/metrics.py and
// text/merge.py. A copy of the JAX package's native/fasttext.cpp.
//
// Build (at first use, into handwritten_ocr_tpu_torch/_build/):
//   g++ -O3 -shared -fPIC fasttext.cpp -o libfasttext-<digest>.so

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Unit-cost Levenshtein distance between two uint32 sequences.
// Two-row DP, O(min(n,m)) memory.
int64_t edit_distance_u32(const uint32_t* a, int64_t n,
                          const uint32_t* b, int64_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    if (m > n) { std::swap(a, b); std::swap(n, m); }

    std::vector<int64_t> row(m + 1);
    for (int64_t j = 0; j <= m; ++j) row[j] = j;

    for (int64_t i = 1; i <= n; ++i) {
        int64_t diag = row[0];
        row[0] = i;
        const uint32_t ai = a[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            const int64_t up = row[j];
            const int64_t sub = diag + (ai != b[j - 1]);
            const int64_t del = up + 1;
            const int64_t ins = row[j - 1] + 1;
            row[j] = std::min(sub, std::min(del, ins));
            diag = up;
        }
    }
    return row[m];
}

// LCS alignment of `words` onto `backbone` (integer codes, already
// case-folded by the caller). Writes aligned[i] = index into words for
// each backbone position, or -1 for a gap. Tie-break during backtracking
// prefers stepping the backbone index (dp[i-1][j] >= dp[i][j-1]),
// matching text/merge.py (and the reference tools.py:483-491).
void lcs_align_i64(const int64_t* backbone, int64_t n,
                   const int64_t* words, int64_t m,
                   int64_t* aligned) {
    for (int64_t i = 0; i < n; ++i) aligned[i] = -1;
    if (n == 0 || m == 0) return;

    std::vector<int32_t> table((n + 1) * (m + 1), 0);
    const int64_t stride = m + 1;
    for (int64_t i = 1; i <= n; ++i) {
        const int64_t bi = backbone[i - 1];
        const int32_t* prev = table.data() + (i - 1) * stride;
        int32_t* cur = table.data() + i * stride;
        for (int64_t j = 1; j <= m; ++j) {
            cur[j] = (bi == words[j - 1])
                ? prev[j - 1] + 1
                : std::max(prev[j], cur[j - 1]);
        }
    }

    int64_t i = n, j = m;
    while (i > 0 && j > 0) {
        if (backbone[i - 1] == words[j - 1]) {
            aligned[i - 1] = j - 1;
            --i; --j;
        } else if (table[(i - 1) * stride + j] >= table[i * stride + j - 1]) {
            --i;
        } else {
            --j;
        }
    }
}

}  // extern "C"
