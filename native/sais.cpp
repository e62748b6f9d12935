// SA-IS suffix array construction (Nong/Zhang/Chan induced-sorting algorithm).
//
// kit4b rebuild: replaces the reference's multithreaded comparison
// quicksort over suffix offsets (reference: libkit4b/SfxArray.cpp:9739 QSortSeq
// with QSortSeqCmp32/40) with an O(n) builder. Equivalence only requires the
// sorted order, which is unique for a fixed text, so any correct SA builder
// produces an identical index (SURVEY.md §7 "Hard parts").
//
// Exposed via a C ABI for ctypes binding; no third-party code.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename I, typename C>
void get_counts(const C* T, I* counts, I n, I K) {
  std::memset(counts, 0, sizeof(I) * K);
  for (I i = 0; i < n; ++i) counts[T[i]]++;
}

template <typename I>
void get_buckets(const I* counts, I* bkt, I K, bool end) {
  I sum = 0;
  for (I k = 0; k < K; ++k) {
    sum += counts[k];
    bkt[k] = end ? sum : sum - counts[k];
  }
}

// t[i] == true means suffix i is S-type.
template <typename I, typename C>
void induce(const C* T, I* SA, const std::vector<bool>& t, I n, I K,
            std::vector<I>& counts, std::vector<I>& bkt) {
  // L-type induction, left to right from bucket heads.
  get_buckets(counts.data(), bkt.data(), K, false);
  for (I i = 0; i < n; ++i) {
    I j = SA[i];
    if (j > 0 && !t[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
  }
  // S-type induction, right to left from bucket ends.
  get_buckets(counts.data(), bkt.data(), K, true);
  for (I i = n - 1; i >= 0; --i) {
    I j = SA[i];
    if (j > 0 && t[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
  }
}

// Core SA-IS over text T[0..n-1] with values in [0, K); requires T[n-1] to be
// the unique smallest character (the explicit sentinel convention).
template <typename I, typename C>
void sais_core(const C* T, I* SA, I n, I K) {
  if (n == 1) { SA[0] = 0; return; }

  std::vector<bool> t(n);
  t[n - 1] = true;
  t[n - 2] = false;  // T[n-2] > T[n-1] since sentinel is unique smallest
  for (I i = n - 3; i >= 0; --i)
    t[i] = (T[i] < T[i + 1]) || (T[i] == T[i + 1] && t[i + 1]);

  std::vector<I> counts(K), bkt(K);
  get_counts(T, counts.data(), n, K);

  // Stage 1: sort LMS substrings.
  for (I i = 0; i < n; ++i) SA[i] = -1;
  get_buckets(counts.data(), bkt.data(), K, true);
  for (I i = n - 1; i >= 1; --i)
    if (t[i] && !t[i - 1]) SA[--bkt[T[i]]] = i;  // place LMS suffixes
  induce(T, SA, t, n, K, counts, bkt);

  // Compact sorted LMS suffixes into SA[0..n1).
  I n1 = 0;
  for (I i = 0; i < n; ++i) {
    I j = SA[i];
    if (j > 0 && t[j] && !t[j - 1]) SA[n1++] = j;
  }

  // Name LMS substrings; names stored in SA[n1..n).
  I* names = SA + n1;
  for (I i = n1; i < n; ++i) SA[i] = -1;
  I name = 0, prev = -1;
  for (I i = 0; i < n1; ++i) {
    I pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      // Compare LMS substrings starting at pos and prev.
      for (I d = 0;; ++d) {
        bool lms_p = (pos + d == n - 1) ||
                     (d > 0 && t[pos + d] && !t[pos + d - 1]);
        bool lms_q = (prev + d == n - 1) ||
                     (d > 0 && t[prev + d] && !t[prev + d - 1]);
        if (T[pos + d] != T[prev + d] || lms_p != lms_q) { diff = true; break; }
        if (d > 0 && (lms_p || lms_q)) break;
      }
    }
    if (diff) { ++name; prev = pos; }
    names[pos / 2] = name - 1;
  }
  // Compact names to the tail of SA.
  I j = n - 1;
  for (I i = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // Stage 2: order LMS suffixes.
  I* SA1 = SA;
  I* T1 = SA + n - n1;
  if (name < n1) {
    sais_core<I, I>(T1, SA1, n1, name);
  } else {
    for (I i = 0; i < n1; ++i) SA1[T1[i]] = i;
  }

  // Map reduced-problem order back to LMS positions (reuse T1 as position list).
  I k = 0;
  for (I i = 1; i < n; ++i)
    if (t[i] && !t[i - 1]) T1[k++] = i;
  for (I i = 0; i < n1; ++i) SA1[i] = T1[SA1[i]];

  // Stage 3: induce the full order from sorted LMS suffixes.
  for (I i = n1; i < n; ++i) SA[i] = -1;
  get_buckets(counts.data(), bkt.data(), K, true);
  for (I i = n1 - 1; i >= 0; --i) {
    I j2 = SA[i];
    SA[i] = -1;
    SA[--bkt[T[j2]]] = j2;
  }
  induce(T, SA, t, n, K, counts, bkt);
}

}  // namespace

extern "C" {

// Build the suffix array of T[0..n-1] (uint8 values, any alphabet) into
// SA[0..n-1]. Returns 0 on success. The text need not contain a sentinel;
// a virtual one is appended internally (suffixes compared as if the text
// ended with a unique smallest character, matching np.argsort over suffixes).
int sais_u8_i32(const uint8_t* T, int32_t* SA, int64_t n) {
  if (n <= 0) return 0;
  if (n == 1) { SA[0] = 0; return 0; }
  if (n >= INT32_MAX - 1) return -1;
  std::vector<uint8_t> T2(n + 1);
  for (int64_t i = 0; i < n; ++i) T2[i] = T[i] + 1;  // shift so 0 is free
  T2[n] = 0;                                         // unique smallest sentinel
  std::vector<int32_t> SA2(n + 1);
  sais_core<int32_t, uint8_t>(T2.data(), SA2.data(), (int32_t)(n + 1), 257);
  std::memcpy(SA, SA2.data() + 1, sizeof(int32_t) * n);  // drop sentinel suffix
  return 0;
}

int sais_u8_i64(const uint8_t* T, int64_t* SA, int64_t n) {
  if (n <= 0) return 0;
  if (n == 1) { SA[0] = 0; return 0; }
  std::vector<uint8_t> T2(n + 1);
  for (int64_t i = 0; i < n; ++i) T2[i] = T[i] + 1;
  T2[n] = 0;
  std::vector<int64_t> SA2(n + 1);
  sais_core<int64_t, uint8_t>(T2.data(), SA2.data(), n + 1, (int64_t)257);
  std::memcpy(SA, SA2.data() + 1, sizeof(int64_t) * n);
  return 0;
}

}  // extern "C"
