// Linear-time suffix array construction by induced sorting (SA-IS,
// Nong/Zhang/Chan 2009).  Builds the persisted ".sqn.st" index written by
// compress_seq -t — the TPU framework's replacement for the reference's
// mmap'd rl_suffix_tree (compress_seq.cc:27-40, rl_suffix_tree.h:13-42) —
// in O(n) instead of the NumPy prefix-doubling O(n log^2 n) fallback.
//
// The suffix order matches the prefix-doubling builder exactly: a suffix
// that is a proper prefix of another sorts first (virtual sentinel smaller
// than every code).
//
// C ABI, bound via ctypes (no pybind11 on this image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int64_t i64;

struct Level {
    const i64 *s;
    i64 n;
    i64 K;
    std::vector<bool> t;  // type: true = S, false = L

    Level(const i64 *s_, i64 n_, i64 K_) : s(s_), n(n_), K(K_), t(n_) {
        t[n - 1] = true;  // the sentinel suffix is S-type
        for (i64 i = n - 2; i >= 0; i--)
            t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);
    }

    bool is_lms(i64 i) const { return i > 0 && t[i] && !t[i - 1]; }

    void bucket_ends(std::vector<i64> &bkt) const {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (i64 i = 0; i < n; i++) bkt[s[i]]++;
        i64 sum = 0;
        for (i64 c = 0; c < K; c++) { sum += bkt[c]; bkt[c] = sum; }
    }

    void bucket_starts(std::vector<i64> &bkt) const {
        std::fill(bkt.begin(), bkt.end(), 0);
        for (i64 i = 0; i < n; i++) bkt[s[i]]++;
        i64 sum = 0;
        for (i64 c = 0; c < K; c++) { i64 cnt = bkt[c]; bkt[c] = sum; sum += cnt; }
    }

    // induce L-suffixes left-to-right, then S-suffixes right-to-left, from
    // whatever sorted seeds are already placed in sa (-1 = empty slot)
    void induce(i64 *sa, std::vector<i64> &bkt) const {
        bucket_starts(bkt);
        for (i64 i = 0; i < n; i++) {
            i64 j = sa[i] - 1;
            if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
        }
        bucket_ends(bkt);
        for (i64 i = n - 1; i >= 0; i--) {
            i64 j = sa[i] - 1;
            if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
        }
    }
};

// s[0..n-1] with s[n-1] == 0, the unique minimum.  sa has room for n.
void sa_is(const i64 *s, i64 *sa, i64 n, i64 K) {
    if (n == 1) { sa[0] = 0; return; }
    Level lv(s, n, K);
    std::vector<i64> bkt(K);

    // stage 1: place LMS positions at their bucket ends, induce once to
    // sort all LMS *substrings*
    std::fill(sa, sa + n, (i64)-1);
    lv.bucket_ends(bkt);
    for (i64 i = 1; i < n; i++)
        if (lv.is_lms(i)) sa[--bkt[s[i]]] = i;
    lv.induce(sa, bkt);

    // compact the sorted LMS positions into sa[0..n1)
    i64 n1 = 0;
    for (i64 i = 0; i < n; i++)
        if (lv.is_lms(sa[i])) sa[n1++] = sa[i];

    // name each LMS substring by rank; equal substrings share a name
    std::fill(sa + n1, sa + n, (i64)-1);
    i64 name = 0, prev = -1;
    for (i64 i = 0; i < n1; i++) {
        i64 pos = sa[i];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (i64 d = 0;; d++) {
                if (s[pos + d] != s[prev + d] || lv.t[pos + d] != lv.t[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (lv.is_lms(pos + d) || lv.is_lms(prev + d)))
                    break;  // both hit their LMS end simultaneously: equal
            }
        }
        if (diff) { name++; prev = pos; }
        sa[n1 + pos / 2] = name - 1;
    }
    for (i64 i = n - 1, j = n - 1; i >= n1; i--)
        if (sa[i] >= 0) sa[j--] = sa[i];

    // stage 2: sort the LMS suffixes — recursively if names repeat
    i64 *s1 = sa + n - n1;
    if (name < n1) {
        sa_is(s1, sa, n1, name);
    } else {
        for (i64 i = 0; i < n1; i++) sa[s1[i]] = i;
    }

    // stage 3: map ranks back to text positions and induce the full order
    for (i64 i = 1, j = 0; i < n; i++)
        if (lv.is_lms(i)) s1[j++] = i;  // LMS positions in text order
    for (i64 i = 0; i < n1; i++) sa[i] = s1[sa[i]];
    std::fill(sa + n1, sa + n, (i64)-1);
    lv.bucket_ends(bkt);
    for (i64 i = n1 - 1; i >= 0; i--) {
        i64 j = sa[i];
        sa[i] = -1;
        sa[--bkt[s[j]]] = j;
    }
    lv.induce(sa, bkt);
}

}  // namespace

extern "C" int sat_suffix_array(const uint8_t *codes, int64_t n, int64_t *out) {
    if (n <= 0) return 0;
    std::vector<i64> s(n + 1);
    for (i64 i = 0; i < n; i++) s[i] = (i64)codes[i] + 1;
    s[n] = 0;  // unique smallest sentinel
    std::vector<i64> sa(n + 1);
    sa_is(s.data(), sa.data(), n + 1, 257);
    std::memcpy(out, sa.data() + 1, n * sizeof(i64));  // drop the sentinel
    return 0;
}
