// Copied from blasr_tpu/native/sais.cpp (unchanged).
// SA-IS suffix array construction (induced sorting), C++17.
//
// Native index-build path for blasr_tpu: the reference builds suffix
// arrays with Larsson-Sadakane (utils/SAWriter.cpp:201-235, O(n log n));
// SA-IS is O(n) and is the modern standard for this artifact.  Written
// from the published algorithm (Nong, Zhang & Chan 2009), not ported from
// any existing implementation.
//
// Exposed C ABI:
//   int sais_u8(const uint8_t* s, int64_t n, int64_t* sa)
// Returns 0 on success.  `sa` must have space for n entries.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename SIdx>
void get_counts(const SIdx* s, int64_t n, int64_t k, std::vector<int64_t>& cnt) {
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t i = 0; i < n; i++) cnt[s[i]]++;
}

void get_buckets(const std::vector<int64_t>& cnt, std::vector<int64_t>& bkt,
                 int64_t k, bool end) {
    int64_t sum = 0;
    for (int64_t i = 0; i < k; i++) {
        sum += cnt[i];
        bkt[i] = end ? sum : sum - cnt[i];
    }
}

// core recursive SA-IS over an integer string s[0..n-1] with alphabet size k
template <typename SIdx>
void sais_core(const SIdx* s, int64_t* sa, int64_t n, int64_t k) {
    if (n == 0) return;
    if (n == 1) { sa[0] = 0; return; }

    std::vector<bool> is_s(n);  // true if suffix i is S-type
    is_s[n - 1] = true;
    for (int64_t i = n - 2; i >= 0; i--)
        is_s[i] = s[i] < s[i + 1] || (s[i] == s[i + 1] && is_s[i + 1]);
    auto is_lms = [&](int64_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

    std::vector<int64_t> cnt(k), bkt(k);
    get_counts(s, n, k, cnt);

    auto induce = [&](void) {
        // induce L from placed LMS/S
        get_buckets(cnt, bkt, k, false);
        for (int64_t i = 0; i < n; i++) {
            int64_t j = sa[i] - 1;
            if (sa[i] > 0 && !is_s[j]) sa[bkt[s[j]]++] = j;
        }
        // induce S
        get_buckets(cnt, bkt, k, true);
        for (int64_t i = n - 1; i >= 0; i--) {
            int64_t j = sa[i] - 1;
            if (sa[i] > 0 && is_s[j]) sa[--bkt[s[j]]] = j;
        }
    };

    // step 1: place LMS suffixes at bucket ends (unsorted), induce
    std::fill(sa, sa + n, -1);
    get_buckets(cnt, bkt, k, true);
    for (int64_t i = n - 1; i >= 1; i--)
        if (is_lms(i)) sa[--bkt[s[i]]] = i;
    // the sentinel-free formulation: treat position n-1 as the smallest
    // suffix only if it is LMS (handled by loop); standard fix: ensure
    // virtual sentinel via caller appending 0 (we require s[n-1] to be the
    // unique minimum, enforced by the wrapper below).
    induce();

    // step 2: compact sorted LMS suffixes, name LMS substrings
    int64_t n_lms = 0;
    for (int64_t i = 0; i < n; i++)
        if (sa[i] >= 0 && is_lms(sa[i])) sa[n_lms++] = sa[i];
    std::fill(sa + n_lms, sa + n, -1);
    int64_t name = 0, prev = -1;
    for (int64_t i = 0; i < n_lms; i++) {
        int64_t pos = sa[i];
        bool diff = false;
        if (prev < 0) diff = true;
        else {
            for (int64_t d = 0; d < n; d++) {
                int64_t a = pos + d, b = prev + d;
                if (a == n || b == n) { diff = (a == n) != (b == n); break; }
                if (s[a] != s[b] || is_s[a] != is_s[b]) { diff = true; break; }
                if (d > 0 && (is_lms(a) || is_lms(b))) {
                    diff = !(is_lms(a) && is_lms(b));
                    break;
                }
            }
        }
        if (diff) { name++; prev = pos; }
        sa[n_lms + pos / 2] = name - 1;
    }
    std::vector<int64_t> s1(n_lms), lms_pos(n_lms);
    {
        int64_t j = 0;
        for (int64_t i = 1; i < n; i++)
            if (is_lms(i)) lms_pos[j++] = i;
        j = 0;
        for (int64_t i = n_lms; i < n; i++)
            if (sa[i] >= 0) s1[j++] = sa[i];
    }

    // step 3: sort LMS order (recurse if names not unique)
    std::vector<int64_t> sa1(n_lms);
    if (name < n_lms) {
        sais_core<int64_t>(s1.data(), sa1.data(), n_lms, name);
    } else {
        for (int64_t i = 0; i < n_lms; i++) sa1[s1[i]] = i;
    }

    // step 4: place LMS in final order, induce again
    std::fill(sa, sa + n, -1);
    get_buckets(cnt, bkt, k, true);
    for (int64_t i = n_lms - 1; i >= 0; i--) {
        int64_t j = lms_pos[sa1[i]];
        sa[--bkt[s[j]]] = j;
    }
    induce();
}

}  // namespace

extern "C" {

// Invert a BWT (bwt2sa path, extrautils/BwtToSuffixArray.cpp role): given
// the BWT of text+sentinel (sentinel occurring exactly once), recover the
// original text (n-1 bytes, sentinel excluded).  The Python fallback walks
// the LF permutation one step per character in interpreter time; this is
// the same walk in native code.
int bwt_invert_u8(const uint8_t* bwt, int64_t n, uint8_t sentinel,
                  uint8_t* out) {
    if (n <= 0) return 1;
    // LF[i] = stable-sort position of bwt[i]
    std::vector<int64_t> cnt(256, 0), start(256, 0);
    for (int64_t i = 0; i < n; i++) cnt[bwt[i]]++;
    int64_t sum = 0;
    for (int c = 0; c < 256; c++) { start[c] = sum; sum += cnt[c]; }
    std::vector<int64_t> lf(n);
    for (int64_t i = 0; i < n; i++) lf[i] = start[bwt[i]]++;
    int64_t row = -1;
    for (int64_t i = 0; i < n; i++)
        if (bwt[i] == sentinel) { row = i; break; }
    if (row < 0) return 2;
    for (int64_t i = n - 2; i >= 0; i--) {
        row = lf[row];
        out[i] = bwt[row];
    }
    return 0;
}

// CIGAR assembly from run-length traceback pairs (host collect hot path).
// words: nwords int32 values, each holding two uint16 halves (low half
// first); each half = op | count << 2, emitted end-first by the device
// traceback; op codes 0 stop, 1 M, 2 I, 3 D.  Decodes, reverses to
// alignment order, coalesces adjacent same-op pairs, and (unless
// allow_adjacent) folds adjacent I/D pairs into mismatch columns ('X'
// runs), matching the Python pairs_to_cigar + merge_adjacent_indels
// semantics exactly.
// out_ops: 1 M, 2 I, 3 D, 4 X.  Returns the run count, or -1 on overflow.
namespace {

// scratch reused across calls (one set per thread) so the per-alignment
// cost is decode work, not allocator churn
struct CigarScratch {
    std::vector<uint8_t> ops, rops, o2;
    std::vector<int32_t> cnt, rcnt, c2;
};

int64_t cigar_decode_one(const uint32_t* words, int64_t nwords,
                         int allow_adjacent, CigarScratch& sc,
                         uint8_t* out_ops, int32_t* out_counts,
                         int64_t max_runs) {
    // decode end-first pairs, stop at op 0, build runs in reverse order
    auto& ops = sc.ops;
    auto& cnt = sc.cnt;
    ops.clear();
    cnt.clear();
    for (int64_t i = 0; i < 2 * nwords; i++) {
        uint32_t h = (i & 1) ? (words[i >> 1] >> 16) : (words[i >> 1] & 0xFFFF);
        uint8_t op = (uint8_t)(h & 3);
        if (op == 0) break;
        int32_t c = (int32_t)(h >> 2);
        if (c == 0) continue;  // no-op pair (traceback stall step)
        if (!ops.empty() && ops.back() == op) {
            cnt.back() += c;
        } else {
            ops.push_back(op);
            cnt.push_back(c);
        }
    }
    // reverse to alignment order
    auto& rops = sc.rops;
    auto& rcnt = sc.rcnt;
    rops.assign(ops.rbegin(), ops.rend());
    rcnt.assign(cnt.rbegin(), cnt.rend());
    if (!allow_adjacent) {
        // iterate until no adjacent I/D (or D/I) pairs remain
        bool changed = true;
        while (changed) {
            changed = false;
            auto& o2 = sc.o2;
            auto& c2 = sc.c2;
            o2.clear();
            c2.clear();
            size_t i = 0;
            auto push = [&](uint8_t op, int32_t n) {
                if (!o2.empty() && o2.back() == op) c2.back() += n;
                else { o2.push_back(op); c2.push_back(n); }
            };
            while (i < rops.size()) {
                if (i + 1 < rops.size()
                    && (rops[i] == 2 || rops[i] == 3)
                    && (rops[i + 1] == 2 || rops[i + 1] == 3)
                    && rops[i] != rops[i + 1]) {
                    int32_t m = std::min(rcnt[i], rcnt[i + 1]);
                    // folded columns consume both sides with unknown
                    // match status -> 'M' (see merge_adjacent_indels)
                    push(1, m);
                    if (rcnt[i] > m) push(rops[i], rcnt[i] - m);
                    if (rcnt[i + 1] > m) push(rops[i + 1], rcnt[i + 1] - m);
                    i += 2;
                    changed = true;
                } else {
                    push(rops[i], rcnt[i]);
                    i++;
                }
            }
            rops.swap(o2);
            rcnt.swap(c2);
        }
    }
    if ((int64_t)rops.size() > max_runs) return -1;
    if (!rops.empty()) {
        std::memcpy(out_ops, rops.data(), rops.size());
        std::memcpy(out_counts, rcnt.data(), rcnt.size() * sizeof(int32_t));
    }
    return (int64_t)rops.size();
}

}  // namespace

int64_t cigar_from_pairs(const uint32_t* words, int64_t nwords,
                         int allow_adjacent,
                         uint8_t* out_ops, int32_t* out_counts,
                         int64_t max_runs) {
    static thread_local CigarScratch sc;
    return cigar_decode_one(words, nwords, allow_adjacent, sc,
                            out_ops, out_counts, max_runs);
}

// Batched variant: one call decodes many traceback rows of a [n_rows,
// row_words] matrix.  slots[j] selects the row for output j; runs are
// emitted contiguously with out_offsets[j]..out_offsets[j+1] delimiting
// output j (out_offsets has n_slots+1 entries).  Returns the total run
// count, or -1 if max_total would be exceeded.
int64_t cigar_from_pairs_batch(const uint32_t* words, int64_t row_words,
                               const int64_t* slots, int64_t n_slots,
                               int allow_adjacent,
                               uint8_t* out_ops, int32_t* out_counts,
                               int64_t* out_offsets, int64_t max_total) {
    static thread_local CigarScratch sc;
    int64_t total = 0;
    out_offsets[0] = 0;
    for (int64_t j = 0; j < n_slots; j++) {
        int64_t n = cigar_decode_one(
            words + slots[j] * row_words, row_words, allow_adjacent, sc,
            out_ops + total, out_counts + total, max_total - total);
        if (n < 0) return -1;
        total += n;
        out_offsets[j + 1] = total;
    }
    return total;
}

// s: byte string; the wrapper appends a unique 0 sentinel internally, so
// callers pass values in [1, 255].  sa receives n entries.
int sais_u8(const uint8_t* s, int64_t n, int64_t* sa) {
    if (n < 0) return 1;
    if (n == 0) return 0;
    // append sentinel: build shifted copy with s'[i] = s[i] (must be >=1),
    // s'[n] = 0
    std::vector<int64_t> tmp(n + 1);
    for (int64_t i = 0; i < n; i++) {
        if (s[i] == 0) return 2;  // caller must 1-shift the alphabet
        tmp[i] = s[i];
    }
    tmp[n] = 0;
    std::vector<int64_t> sa_full(n + 1);
    sais_core<int64_t>(tmp.data(), sa_full.data(), n + 1, 256);
    // drop the sentinel suffix (sorts first)
    std::memcpy(sa, sa_full.data() + 1, sizeof(int64_t) * n);
    return 0;
}
}
