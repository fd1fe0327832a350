// Native host-side ops for the OpenProvence-TPU inference engine.
//
// The reference's host pipeline leans on native code through its
// dependencies (Rust tokenizers, torch DataLoader workers — SURVEY §2.3);
// this framework's own host hot paths are implemented here:
//
//  * find_subsequence — token-range recovery by subsequence search inside
//    prepared block inputs (reference standalone:2159-2170, O(n·m) scan per
//    block, the inner loop of _prepare_block_inputs),
//  * greedy_pack — fragment→block greedy packing plan
//    (reference standalone:2222-2259),
//  * pad_block_batch_i32 — fill padded [batch, seq] id/mask arrays from
//    ragged rows (reference pad-to-max loop standalone:2832-2880).
//
// Build: g++ -O3 -shared -fPIC host_ops.cpp -o libhost_ops.so
// Python binds via ctypes (open_provence_tpu/native/__init__.py), with pure
// Python fallbacks kept behavior-identical (tests/test_native_ops.py).

#include <cstdint>
#include <cstring>

namespace {

// Python str.isspace() / re \s over the ASCII range: \t \n \v \f \r,
// the FS/GS/RS/US separators \x1c-\x1f, and space.
inline bool py_isspace(unsigned char c) {
    return (c >= 9 && c <= 13) || (c >= 28 && c <= 31) || c == 32;
}

inline bool is_ascii_alpha(unsigned char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
}

inline bool is_ascii_digit(unsigned char c) { return c >= '0' && c <= '9'; }

inline bool is_sent_punct(unsigned char c) { return c == '.' || c == '!' || c == '?'; }

inline bool is_close_quote(unsigned char c) {
    return c == '"' || c == '\'' || c == ')' || c == ']';
}

// Python str.splitlines() boundaries within ASCII: \n, \r (\r\n combined),
// \v, \f, and \x1c-\x1e.
inline bool is_line_term(unsigned char c) {
    return c == '\n' || c == '\r' || c == 11 || c == 12 ||
           (c >= 28 && c <= 30);
}

// Abbreviations guarding single-'.' sentence ends (mirrors the Python
// frozenset in text/splitters.py; entries are already lowercase with no
// trailing dot).
const char* kAbbrev[] = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "etc", "vs", "e.g",
    "i.e", "fig", "no", "vol", "inc", "ltd", "co", "corp", "dept", "univ",
    "approx", "est", "min", "max", "u.s", "u.k", "a.m", "p.m",
};

bool is_abbrev(const char* w, int64_t len) {
    for (const char* cand : kAbbrev) {
        int64_t i = 0;
        while (i < len && cand[i] && cand[i] == w[i]) ++i;
        if (i == len && cand[i] == 0) return true;
    }
    return false;
}

struct SpanSink {
    int64_t* out;
    int64_t cap;    // in pairs
    int64_t count;  // pairs produced (may exceed cap)

    void emit(int64_t lo, int64_t hi) {
        if (count < cap) {
            out[2 * count] = lo;
            out[2 * count + 1] = hi;
        }
        ++count;
    }
};

// split_overlong_sentence(segment, preserve_whitespace=True): clip
// [lo, hi) into <= max_chars pieces at newline-then-punctuation boundaries.
void clip_emit(const char* t, int64_t lo, int64_t hi, int64_t max_chars,
               SpanSink* sink) {
    if (hi - lo <= max_chars) {
        if (hi > lo) sink->emit(lo, hi);
        return;
    }
    int64_t p = lo;
    while (p < hi) {
        int64_t q = p + max_chars;
        if (q > hi) q = hi;
        // _clip_boundary: last '\n' in (p, q) -> cut after it; else last
        // sentence punctuation scanned from q down; else q.
        int64_t cut = -1;
        for (int64_t i = q - 1; i >= p + 1; --i) {
            if (t[i] == '\n') { cut = i + 1; break; }
        }
        if (cut < 0) {
            for (int64_t i = q; i >= p + 1; --i) {
                unsigned char c = (unsigned char)t[i - 1];
                if (c == '.' || c == '?' || c == '!' || c == ';' || c == ':' ||
                    c == '\n') { cut = i; break; }
            }
        }
        if (cut < 0) cut = q;
        sink->emit(p, cut);  // cut > p always, piece non-empty
        p = cut;
    }
}

// _regex_span_tokenize over the block [blo, bhi), emitting whitespace-
// absorbed, clipped segments like _EnglishSplitter.__call__ does
// (spans trimmed, then extended through trailing whitespace bounded by the
// block, then overlong-clipped).
void tokenize_block(const char* t, int64_t blo, int64_t bhi, int64_t max_chars,
                    SpanSink* sink) {
    bool any_nonspace = false;
    for (int64_t i = blo; i < bhi; ++i) {
        if (!py_isspace((unsigned char)t[i])) { any_nonspace = true; break; }
    }
    if (!any_nonspace) return;

    auto emit_span = [&](int64_t s, int64_t e) {
        // trimmed(s, e) in block coords, whitespace-absorbed to block end.
        while (s < e && py_isspace((unsigned char)t[s])) ++s;
        while (e > s && py_isspace((unsigned char)t[e - 1])) --e;
        if (s >= e) return;
        int64_t end = e;
        while (end < bhi && py_isspace((unsigned char)t[end])) ++end;
        clip_emit(t, s, end, max_chars, sink);
    };

    int64_t start = blo;
    int64_t i = blo;
    while (i < bhi) {
        if (!is_sent_punct((unsigned char)t[i])) { ++i; continue; }
        int64_t run_end = i;
        bool has_dot = false;
        while (run_end < bhi && is_sent_punct((unsigned char)t[run_end])) {
            if (t[run_end] == '.') has_dot = true;
            ++run_end;
        }
        int64_t match_end = run_end;
        while (match_end < bhi && is_close_quote((unsigned char)t[match_end]))
            ++match_end;
        int64_t next_scan = match_end;  // finditer is non-overlapping

        // Candidate word before the punctuation: within the previous <=12
        // chars, the leftmost alpha whose following chars are all [A-Za-z.].
        int64_t wlo = i - 12;
        if (wlo < blo) wlo = blo;
        int64_t wend = i;
        // Python's re `$` also matches just before ONE trailing newline, so
        // the word search ignores a final '\n' in the window.
        if (wend > wlo && t[wend - 1] == '\n') --wend;
        int64_t run_start = wend;
        while (run_start > wlo) {
            unsigned char c = (unsigned char)t[run_start - 1];
            if (is_ascii_alpha(c) || c == '.') --run_start;
            else break;
        }
        int64_t word_lo = run_start;
        while (word_lo < wend && t[word_lo] == '.') ++word_lo;
        char word[16];
        int64_t word_len = 0;
        if (word_lo < wend && is_ascii_alpha((unsigned char)t[word_lo])) {
            for (int64_t k = word_lo; k < wend && word_len < 14; ++k) {
                unsigned char c = (unsigned char)t[k];
                word[word_len++] =
                    (c >= 'A' && c <= 'Z') ? (char)(c + 32) : (char)c;
            }
            while (word_len > 0 && word[word_len - 1] == '.') --word_len;
        }

        bool is_end = true;
        if (has_dot && (run_end - i) == 1) {
            if (word_len > 0 &&
                (is_abbrev(word, word_len) ||
                 (word_len == 1 && is_ascii_alpha((unsigned char)word[0])))) {
                is_end = false;
            } else if (match_end < bhi &&
                       is_ascii_digit((unsigned char)t[match_end])) {
                is_end = false;  // numeric like "3.14"
            }
        }
        if (is_end && match_end < bhi &&
            !py_isspace((unsigned char)t[match_end])) {
            is_end = false;  // require whitespace-or-EOB after
        }
        if (is_end) {
            emit_span(start, match_end);
            start = match_end;
        }
        i = next_scan;
    }
    emit_span(start, bhi);
}

// _BULLET_RE match against the line [ls, le) with trailing \r\n stripped:
// ^\s*(?:[-*]+|\d{1,4}[:.)]|[A-Za-z][:.)])\s+  (the bullet glyphs in the
// Python class are non-ASCII and cannot occur in ASCII text).
bool bullet_match(const char* t, int64_t ls, int64_t le) {
    while (le > ls && (t[le - 1] == '\r' || t[le - 1] == '\n')) --le;
    int64_t i = ls;
    while (i < le && py_isspace((unsigned char)t[i])) ++i;
    if (i >= le) return false;
    int64_t marker_end = -1;
    unsigned char c = (unsigned char)t[i];
    if (c == '-' || c == '*') {
        int64_t j = i;
        while (j < le && (t[j] == '-' || t[j] == '*')) ++j;
        marker_end = j;
    } else if (is_ascii_digit(c)) {
        int64_t j = i;
        while (j < le && is_ascii_digit((unsigned char)t[j])) ++j;
        // Only the full digit run can precede [:.)] (shorter backtracks hit
        // another digit); the run must be 1-4 long.
        if (j - i <= 4 && j < le &&
            (t[j] == ':' || t[j] == '.' || t[j] == ')')) {
            marker_end = j + 1;
        }
    }
    if (marker_end < 0 && is_ascii_alpha(c)) {
        if (i + 1 < le && (t[i + 1] == ':' || t[i + 1] == '.' || t[i + 1] == ')')) {
            marker_end = i + 2;
        }
    }
    if (marker_end < 0) return false;
    return marker_end < le && py_isspace((unsigned char)t[marker_end]);
}

}  // namespace

extern "C" {

// Return the first index where `needle` occurs in `haystack`, else -1.
int32_t op_find_subsequence(const int32_t* haystack, int32_t n,
                            const int32_t* needle, int32_t m) {
    if (m <= 0 || n < m) return -1;
    const int32_t first = needle[0];
    const int32_t limit = n - m;
    for (int32_t i = 0; i <= limit; ++i) {
        if (haystack[i] != first) continue;
        int32_t j = 1;
        for (; j < m; ++j) {
            if (haystack[i + j] != needle[j]) break;
        }
        if (j == m) return i;
    }
    return -1;
}

// Greedy packing plan. Inputs: fragment token lengths. Outputs:
//   block_ids[i]  — block index assigned to fragment i,
//   new_lens[i]   — fragment length after truncation (== lens[i] unless the
//                   fragment alone exceeds capacity, then min(len, capacity)
//                   with capacity = max(1, available - base)).
// Returns the number of blocks.
int32_t op_greedy_pack(const int32_t* lens, int32_t n_fragments,
                       int32_t base_len, int32_t available_len,
                       int32_t* block_ids, int32_t* new_lens) {
    if (n_fragments <= 0) return 0;
    int32_t capacity = available_len - base_len;
    if (capacity < 1) capacity = 1;

    int32_t block = 0;
    int32_t current_len = base_len;
    bool block_open = false;
    for (int32_t i = 0; i < n_fragments; ++i) {
        int32_t len = lens[i];
        if (current_len + len <= available_len) {
            block_ids[i] = block;
            new_lens[i] = len;
            current_len += len;
            block_open = true;
            continue;
        }
        if (block_open) {
            ++block;
            block_open = false;
            current_len = base_len;
        }
        int32_t truncated = len > capacity ? capacity : len;
        block_ids[i] = block;
        new_lens[i] = truncated;
        current_len = base_len + truncated;
        block_open = true;
    }
    return block + 1;
}

// Fill input_ids [batch, seq] (pre-filled with pad) and attention
// [batch, seq] (pre-zeroed) from a flat ragged buffer of rows.
void op_pad_block_batch_i32(const int32_t* flat_ids, const int32_t* row_lens,
                            int32_t n_rows, int32_t seq_len,
                            int32_t* input_ids, int32_t* attention) {
    int64_t cursor = 0;
    for (int32_t r = 0; r < n_rows; ++r) {
        int32_t len = row_lens[r];
        int32_t copy_len = len < seq_len ? len : seq_len;
        std::memcpy(input_ids + (int64_t)r * seq_len, flat_ids + cursor,
                    (size_t)copy_len * sizeof(int32_t));
        for (int32_t c = 0; c < copy_len; ++c) {
            attention[(int64_t)r * seq_len + c] = 1;
        }
        cursor += len;
    }
}

// English sentence splitting for ASCII text: the native fast path of
// text/splitters._EnglishSplitter (regex mode). Writes up to `cap`
// (start, end) pairs — substring spans of `t` whose slices are exactly the
// splitter's output — and returns the number of spans needed (callers
// re-invoke with a larger buffer when count > cap). Python handles the
// empty-input and non-ASCII cases.
int64_t op_en_split_spans(const char* t, int64_t n, int64_t max_chars,
                          int64_t* out, int64_t cap) {
    SpanSink sink{out, cap, 0};

    // _iter_english_blocks: cut before every bullet-style line except one
    // at offset 0, scanning splitlines(keepends=True) boundaries.
    int64_t block_lo = 0;
    int64_t line_lo = 0;
    while (line_lo < n) {
        int64_t line_hi = line_lo;
        while (line_hi < n && !is_line_term((unsigned char)t[line_hi])) ++line_hi;
        if (line_hi < n) {
            if (t[line_hi] == '\r' && line_hi + 1 < n && t[line_hi + 1] == '\n')
                line_hi += 2;
            else
                line_hi += 1;
        }
        if (line_lo > 0 && bullet_match(t, line_lo, line_hi)) {
            if (line_lo > block_lo)
                tokenize_block(t, block_lo, line_lo, max_chars, &sink);
            block_lo = line_lo;
        }
        line_lo = line_hi;
    }
    if (n > block_lo) tokenize_block(t, block_lo, n, max_chars, &sink);

    if (sink.count == 0) {
        int64_t s = 0, e = n;
        while (s < e && py_isspace((unsigned char)t[s])) ++s;
        while (e > s && py_isspace((unsigned char)t[e - 1])) --e;
        if (e > s) sink.emit(s, e);
    }
    return sink.count;
}

}  // extern "C"
