// Fast Solidity pretokenizer + vocab encoder (C API, loaded via ctypes).
//
// Native replacement for the host-side tokenization hot path: the reference
// tokenizes every contract AND re-tokenizes every line separately to build
// token_to_line (SCT-GAN/dataset.py:154-173, inference.py:179-203) through a
// Python regex + dict pipeline. This scanner reproduces the framework's
// pretokenization grammar (data/tokenizer.py::_PRETOKEN_RE) byte-for-byte,
// resolves vocab ids with the same CRC32 OOV bucketing, and computes the
// per-token line index in the same single pass — one C call per contract
// instead of O(lines) tokenizer invocations.
//
// Build: g++ -O3 -shared -fPIC -o libfast_tokenizer.so fast_tokenizer.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> table;
    int32_t vocab_size = 0;
    int32_t first_free = 0;
    int32_t unk_id = 3;
};

// CRC32 (IEEE 802.3, zlib-compatible) so OOV bucket ids match
// Python's zlib.crc32 exactly (data/tokenizer.py::_hash_id).
uint32_t crc32_of(const char* data, size_t len) {
    static uint32_t table[256];
    static bool init = false;
    if (!init) {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            table[i] = c;
        }
        init = true;
    }
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = table[(c ^ static_cast<uint8_t>(data[i])) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

inline bool is_ident_start(char c) {
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || c == '_' ||
           c == '$';
}
inline bool is_ident(char c) {
    return is_ident_start(c) || (c >= '0' && c <= '9');
}
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
inline bool is_hex(char c) {
    return is_digit(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F');
}
inline bool is_space_not_nl(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v';
}

// Multi-char operators, longest-match-first, mirroring the regex
// alternation: == != <= >= && || += -= *= /= => -> ** ++ -- << >>
inline int match_multiop(const char* s, size_t remaining) {
    if (remaining < 2) return 0;
    const char a = s[0], b = s[1];
    switch (a) {
        case '=': if (b == '=' || b == '>') return 2; break;
        case '!': if (b == '=') return 2; break;
        case '<': if (b == '=' || b == '<') return 2; break;
        case '>': if (b == '=' || b == '>') return 2; break;
        case '&': if (b == '&') return 2; break;
        case '|': if (b == '|') return 2; break;
        case '+': if (b == '=' || b == '+') return 2; break;
        case '-': if (b == '=' || b == '-' || b == '>') return 2; break;
        case '*': if (b == '=' || b == '*') return 2; break;
        case '/': if (b == '=') return 2; break;
    }
    return 0;
}

// One token starting at s[i]; returns length (0 = skip one char).
// Grammar order matches _PRETOKEN_RE: string | hex | decimal | integer |
// identifier | multiop | single punct.
size_t next_token(const char* s, size_t i, size_t n) {
    const char c = s[i];
    if (c == '"' || c == '\'') {
        size_t j = i + 1;
        while (j < n) {
            if (s[j] == '\\' && j + 1 < n) { j += 2; continue; }
            if (s[j] == c) return j - i + 1;
            j++;
        }
        return 1;  // unterminated string: regex falls through to punct
    }
    if (c == '0' && i + 1 < n && (s[i + 1] == 'x' || s[i + 1] == 'X')
        && i + 2 < n && is_hex(s[i + 2])) {
        size_t j = i + 2;
        while (j < n && is_hex(s[j])) j++;
        return j - i;
    }
    if (is_digit(c)) {
        size_t j = i;
        while (j < n && is_digit(s[j])) j++;
        // decimal: digits '.' digits
        if (j < n && s[j] == '.' && j + 1 < n && is_digit(s[j + 1])) {
            size_t k = j + 1;
            while (k < n && is_digit(s[k])) k++;
            return k - i;
        }
        return j - i;
    }
    if (is_ident_start(c)) {
        size_t j = i + 1;
        while (j < n && is_ident(s[j])) j++;
        return j - i;
    }
    if (int m = match_multiop(s + i, n - i)) return static_cast<size_t>(m);
    return 1;  // single punctuation char
}

int32_t lookup(const Vocab* v, const char* tok, size_t len) {
    auto it = v->table.find(std::string(tok, len));
    if (it != v->table.end()) return it->second;
    const int32_t span = v->vocab_size - v->first_free;
    if (span <= 0) return v->unk_id;
    return v->first_free +
           static_cast<int32_t>(crc32_of(tok, len) % static_cast<uint32_t>(span));
}

}  // namespace

extern "C" {

void* ft_create(int32_t vocab_size, int32_t first_free) {
    Vocab* v = new Vocab();
    v->vocab_size = vocab_size;
    v->first_free = first_free;
    return v;
}

void ft_add_token(void* handle, const char* token, int32_t id) {
    static_cast<Vocab*>(handle)->table.emplace(token, id);
}

void ft_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// Whole-text encode: the Python regex over the full text — string literals
// may span newlines. Whitespace never matches (the regex's last alternation
// excludes \s), it only separates tokens. Returns the token count.
int32_t ft_encode(void* handle, const char* text, int32_t text_len,
                  int32_t* out_ids, int32_t max_out) {
    const Vocab* v = static_cast<Vocab*>(handle);
    const char* s = text;
    const size_t n = static_cast<size_t>(text_len);
    size_t i = 0;
    int32_t count = 0;
    while (i < n && count < max_out) {
        const char c = s[i];
        if (c == '\n' || is_space_not_nl(c)) { i++; continue; }
        size_t len = next_token(s, i, n);
        if (len == 0) { i++; continue; }
        out_ids[count++] = lookup(v, s + i, len);
        i += len;
    }
    return count;
}

// Line-indexed encode with PER-LINE tokenization semantics: each line is
// scanned independently, exactly like the reference's token_to_line recipe
// that tokenizes every line separately (SCT-GAN/dataset.py:154-173) — an
// unterminated string on a line falls through to punctuation tokens instead
// of spanning into the next line. Returns the token count.
int32_t ft_encode_lines(void* handle, const char* text, int32_t text_len,
                        int32_t* out_ids, int32_t* out_lines,
                        int32_t max_out) {
    const Vocab* v = static_cast<Vocab*>(handle);
    const char* s = text;
    const size_t n = static_cast<size_t>(text_len);
    size_t line_start = 0;
    int32_t count = 0;
    int32_t line = 0;
    while (line_start <= n && count < max_out) {
        size_t line_end = line_start;
        while (line_end < n && s[line_end] != '\n') line_end++;
        size_t i = line_start;
        while (i < line_end && count < max_out) {
            if (is_space_not_nl(s[i])) { i++; continue; }
            size_t len = next_token(s + line_start, i - line_start,
                                    line_end - line_start);
            if (len == 0) { i++; continue; }
            out_ids[count] = lookup(v, s + i, len);
            out_lines[count] = line;
            count++;
            i += len;
        }
        if (line_end >= n) break;
        line_start = line_end + 1;
        line++;
    }
    return count;
}

}  // extern "C"
