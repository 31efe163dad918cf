// Native GPT-2 byte-level BPE tokenizer for the BayeFormers-TPU decoder
// families (models/gpt2.py, models/llama.py serving & workloads).
//
// The reference tokenizes through HuggingFace's Python tokenizers
// (`examples/bert_squad.py:146-165` — same stack its GPT-2-era siblings
// use); this is a standalone C++ implementation of the GPT-2 scheme:
// regex-style pre-tokenization (contractions / optional-space letter, digit
// and symbol runs / trailing-whitespace splitting), the byte<->unicode
// remapping of the vocab alphabet, rank-greedy byte-pair merging with a
// per-pretoken cache, and lossless byte-level decode. Exposed through a
// minimal C ABI consumed via ctypes (no pybind11 in this environment),
// with a thread-pooled batch encoder like wordpiece.cc.
//
// Files consumed are the stock HF GPT-2 artifacts, parsed natively:
//   vocab.json  — {"mapped-token": id} (a constrained JSON parser handles
//                 exactly this shape incl. \uXXXX escapes + UTF-8 keys)
//   merges.txt  — "#version" header + one "A B" pair per line (mapped
//                 alphabet); line order is merge rank
//
// Unicode-category fidelity: the pre-tokenizer is exact for ASCII and for
// Unicode whitespace; codepoints >= 0x80 that are not whitespace are
// classified as letters (\p{L}) — correct for the Latin/CJK text these
// vocabularies target, an approximation for non-ASCII digits and symbols
// (documented; the Python fallback in native/__init__.py applies the SAME
// approximation so both backends agree bit-for-bit, and the HF-parity tests
// cover the exactness domain).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread bpe.cc -o libbpe.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// UTF-8 (same helpers as wordpiece.cc)
// ---------------------------------------------------------------------------

uint32_t next_codepoint(const std::string& s, size_t& i) {
  unsigned char c = s[i];
  uint32_t cp = 0;
  int extra = 0;
  if (c < 0x80) {
    cp = c;
  } else if ((c >> 5) == 0x6) {
    cp = c & 0x1F;
    extra = 1;
  } else if ((c >> 4) == 0xE) {
    cp = c & 0x0F;
    extra = 2;
  } else if ((c >> 3) == 0x1E) {
    cp = c & 0x07;
    extra = 3;
  } else {
    ++i;
    return 0xFFFD;
  }
  ++i;
  for (int k = 0; k < extra && i < s.size(); ++k, ++i) {
    cp = (cp << 6) | (s[i] & 0x3F);
  }
  return cp;
}

void append_codepoint(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Unicode \s per Python's re on str (what GPT-2's pattern uses).
bool is_space_cp(uint32_t cp) {
  switch (cp) {
    case ' ': case '\t': case '\n': case '\r': case 0x0B: case 0x0C:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F: case 0x85: case 0xA0:
    case 0x1680: case 0x2028: case 0x2029: case 0x202F: case 0x205F:
    case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

bool is_letter_cp(uint32_t cp) {
  if (cp < 0x80) {
    return (cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z');
  }
  // >= 0x80 non-whitespace: treated as \p{L} (see header note)
  return !is_space_cp(cp);
}

bool is_digit_cp(uint32_t cp) { return cp >= '0' && cp <= '9'; }

// ---------------------------------------------------------------------------
// GPT-2 byte<->unicode alphabet (tokenization_gpt2.bytes_to_unicode)
// ---------------------------------------------------------------------------

// cp_to_byte[codepoint] for the 256 alphabet codepoints.
std::unordered_map<uint32_t, uint8_t> alphabet_inverse() {
  std::unordered_map<uint32_t, uint8_t> inv;
  bool direct[256] = {false};
  for (int b = '!'; b <= '~'; ++b) direct[b] = true;
  for (int b = 0xA1; b <= 0xAC; ++b) direct[b] = true;
  for (int b = 0xAE; b <= 0xFF; ++b) direct[b] = true;
  int n = 0;
  for (int b = 0; b < 256; ++b) {
    if (direct[b]) {
      inv[static_cast<uint32_t>(b)] = static_cast<uint8_t>(b);
    } else {
      inv[static_cast<uint32_t>(256 + n)] = static_cast<uint8_t>(b);
      ++n;
    }
  }
  return inv;
}

// Mapped-alphabet UTF-8 string (vocab.json / merges.txt form) -> raw bytes.
bool unmap_token(const std::string& mapped,
                 const std::unordered_map<uint32_t, uint8_t>& inv,
                 std::string* out) {
  out->clear();
  size_t i = 0;
  while (i < mapped.size()) {
    uint32_t cp = next_codepoint(mapped, i);
    auto it = inv.find(cp);
    if (it == inv.end()) return false;
    out->push_back(static_cast<char>(it->second));
  }
  return true;
}

// ---------------------------------------------------------------------------
// Constrained JSON parser for {"token": id, ...}
// ---------------------------------------------------------------------------

void skip_ws(const std::string& s, size_t& i) {
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t' || s[i] == '\n' ||
                          s[i] == '\r')) {
    ++i;
  }
}

// Parses a JSON string starting at the opening quote; returns UTF-8.
bool parse_json_string(const std::string& s, size_t& i, std::string* out) {
  if (i >= s.size() || s[i] != '"') return false;
  ++i;
  out->clear();
  uint32_t pending_high = 0;  // surrogate pair state
  while (i < s.size()) {
    char c = s[i];
    if (c == '"') {
      ++i;
      return true;
    }
    if (c == '\\') {
      if (i + 1 >= s.size()) return false;
      char e = s[i + 1];
      i += 2;
      switch (e) {
        case '"': out->push_back('"'); break;
        case '\\': out->push_back('\\'); break;
        case '/': out->push_back('/'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'n': out->push_back('\n'); break;
        case 'r': out->push_back('\r'); break;
        case 't': out->push_back('\t'); break;
        case 'u': {
          if (i + 4 > s.size()) return false;
          uint32_t cp = 0;
          for (int k = 0; k < 4; ++k) {
            char h = s[i + k];
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          i += 4;
          if (cp >= 0xD800 && cp <= 0xDBFF) {
            pending_high = cp;
            continue;
          }
          if (cp >= 0xDC00 && cp <= 0xDFFF && pending_high) {
            cp = 0x10000 + ((pending_high - 0xD800) << 10) + (cp - 0xDC00);
            pending_high = 0;
          }
          append_codepoint(*out, cp);
          break;
        }
        default: return false;
      }
      continue;
    }
    out->push_back(c);
    ++i;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Tokenizer state
// ---------------------------------------------------------------------------

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    size_t a = h(p.first);
    return a ^ (h(p.second) + 0x9E3779B97F4A7C15ULL + (a << 6) + (a >> 2));
  }
};

struct BPE {
  // raw-byte token -> id, and the inverse (for decode)
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> id_to_token;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
  // per-pretoken memo (raw bytes -> ids); bounded, guarded for batch threads
  mutable std::unordered_map<std::string, std::vector<int32_t>> cache;
  mutable std::mutex cache_mu;
  static constexpr size_t kCacheMax = 1 << 16;
};

BPE* load_bpe(const char* vocab_path, const char* merges_path) {
  std::ifstream vf(vocab_path, std::ios::binary);
  std::ifstream mf(merges_path, std::ios::binary);
  if (!vf || !mf) return nullptr;
  std::stringstream vb;
  vb << vf.rdbuf();
  const std::string vjson = vb.str();

  auto inv = alphabet_inverse();
  auto bpe = new BPE();

  // vocab.json: { "key": int, ... }
  size_t i = 0;
  skip_ws(vjson, i);
  if (i >= vjson.size() || vjson[i] != '{') {
    delete bpe;
    return nullptr;
  }
  ++i;
  int32_t max_id = -1;
  while (true) {
    skip_ws(vjson, i);
    if (i < vjson.size() && vjson[i] == '}') break;
    std::string key;
    if (!parse_json_string(vjson, i, &key)) {
      delete bpe;
      return nullptr;
    }
    skip_ws(vjson, i);
    if (i >= vjson.size() || vjson[i] != ':') {
      delete bpe;
      return nullptr;
    }
    ++i;
    skip_ws(vjson, i);
    int32_t id = 0;
    bool any = false;
    while (i < vjson.size() && vjson[i] >= '0' && vjson[i] <= '9') {
      id = id * 10 + (vjson[i] - '0');
      ++i;
      any = true;
    }
    if (!any) {
      delete bpe;
      return nullptr;
    }
    std::string raw;
    if (unmap_token(key, inv, &raw)) {
      bpe->vocab.emplace(std::move(raw), id);
      if (id > max_id) max_id = id;
    }  // non-alphabet keys (added special tokens) are skipped: byte-level
       // coverage means encode never needs them, and decode of unknown ids
       // yields empty bytes
    skip_ws(vjson, i);
    if (i < vjson.size() && vjson[i] == ',') {
      ++i;
      continue;
    }
    break;
  }
  bpe->id_to_token.assign(static_cast<size_t>(max_id) + 1, std::string());
  for (const auto& kv : bpe->vocab) {
    bpe->id_to_token[kv.second] = kv.first;
  }

  // merges.txt
  std::string line;
  int32_t rank = 0;
  while (std::getline(mf, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty() || line[0] == '#') continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    std::string a, b;
    if (!unmap_token(line.substr(0, sp), inv, &a) ||
        !unmap_token(line.substr(sp + 1), inv, &b)) {
      continue;
    }
    bpe->ranks.emplace(std::make_pair(std::move(a), std::move(b)), rank++);
  }
  return bpe;
}

// ---------------------------------------------------------------------------
// Pre-tokenizer: GPT-2's pattern over codepoints
//   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
// Alternatives tried in order at each position; see header for the Unicode
// approximation. Emits raw-byte substrings of the UTF-8 input.
// ---------------------------------------------------------------------------

void pretokenize(const std::string& text, std::vector<std::string>* out) {
  // Decode once into (codepoint, byte offset) arrays.
  std::vector<uint32_t> cps;
  std::vector<size_t> offs;
  size_t i = 0;
  while (i < text.size()) {
    offs.push_back(i);
    cps.push_back(next_codepoint(text, i));
  }
  offs.push_back(text.size());
  const size_t n = cps.size();

  auto emit = [&](size_t a, size_t b) {
    out->emplace_back(text.substr(offs[a], offs[b] - offs[a]));
  };

  size_t p = 0;
  while (p < n) {
    // 1. contractions (ASCII apostrophe, lowercase suffixes — the literal
    //    pattern; "'S" deliberately does NOT match, as in HF)
    if (cps[p] == '\'' && p + 1 < n) {
      uint32_t c1 = cps[p + 1];
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') {
        emit(p, p + 2);
        p += 2;
        continue;
      }
      if (p + 2 < n) {
        uint32_t c2 = cps[p + 2];
        if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
            (c1 == 'l' && c2 == 'l')) {
          emit(p, p + 3);
          p += 3;
          continue;
        }
      }
    }
    // 2-4. optional single literal space + letter/digit/other run
    size_t k = p + (cps[p] == ' ' && p + 1 < n ? 1 : 0);
    if (k < n && is_letter_cp(cps[k])) {
      size_t e = k;
      while (e < n && is_letter_cp(cps[e])) ++e;
      emit(p, e);
      p = e;
      continue;
    }
    if (k < n && is_digit_cp(cps[k])) {
      size_t e = k;
      while (e < n && is_digit_cp(cps[e])) ++e;
      emit(p, e);
      p = e;
      continue;
    }
    if (k < n && !is_space_cp(cps[k]) && !is_letter_cp(cps[k]) &&
        !is_digit_cp(cps[k])) {
      size_t e = k;
      while (e < n && !is_space_cp(cps[e]) && !is_letter_cp(cps[e]) &&
             !is_digit_cp(cps[e])) {
        ++e;
      }
      emit(p, e);
      p = e;
      continue;
    }
    // 5. whitespace runs: \s+(?!\S) keeps the final ws char for the next
    //    token when one follows; a lone non-' ' ws before \S rides \s+
    if (is_space_cp(cps[p])) {
      size_t e = p;
      while (e < n && is_space_cp(cps[e])) ++e;
      if (e == n) {
        emit(p, e);  // trailing whitespace: whole run
        p = e;
      } else if (e - p > 1) {
        emit(p, e - 1);  // all but the last ws char
        p = e - 1;
      } else {
        emit(p, e);  // single non-' ' ws (or ' ' at n-1 handled above)
        p = e;
      }
      continue;
    }
    // unreachable fallback: emit the single codepoint
    emit(p, p + 1);
    ++p;
  }
}

// ---------------------------------------------------------------------------
// Rank-greedy BPE over raw bytes
// ---------------------------------------------------------------------------

void bpe_word(const BPE& bpe, const std::string& word,
              std::vector<int32_t>* out) {
  {
    std::lock_guard<std::mutex> lock(bpe.cache_mu);
    auto it = bpe.cache.find(word);
    if (it != bpe.cache.end()) {
      out->insert(out->end(), it->second.begin(), it->second.end());
      return;
    }
  }
  std::vector<std::string> parts;
  parts.reserve(word.size());
  for (char c : word) parts.emplace_back(1, c);
  while (parts.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best = 0;
    for (size_t j = 0; j + 1 < parts.size(); ++j) {
      auto it = bpe.ranks.find(std::make_pair(parts[j], parts[j + 1]));
      if (it != bpe.ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best = j;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge ALL occurrences of the best pair left-to-right (HF semantics)
    std::vector<std::string> merged;
    merged.reserve(parts.size());
    const std::string& a = parts[best];
    const std::string& b = parts[best + 1];
    for (size_t j = 0; j < parts.size();) {
      if (j + 1 < parts.size() && parts[j] == a && parts[j + 1] == b) {
        merged.emplace_back(a + b);
        j += 2;
      } else {
        merged.emplace_back(std::move(parts[j]));
        ++j;
      }
    }
    parts.swap(merged);
  }
  std::vector<int32_t> ids;
  ids.reserve(parts.size());
  for (const auto& piece : parts) {
    auto it = bpe.vocab.find(piece);
    if (it != bpe.vocab.end()) {
      ids.push_back(it->second);
    } else {
      // byte-level alphabets make this unreachable with stock files; fall
      // back to per-byte ids so encode() is total regardless
      for (char c : piece) {
        auto bi = bpe.vocab.find(std::string(1, c));
        if (bi != bpe.vocab.end()) ids.push_back(bi->second);
      }
    }
  }
  {
    std::lock_guard<std::mutex> lock(bpe.cache_mu);
    if (bpe.cache.size() < BPE::kCacheMax) bpe.cache.emplace(word, ids);
  }
  out->insert(out->end(), ids.begin(), ids.end());
}

void encode_text(const BPE& bpe, const std::string& text,
                 std::vector<int32_t>* out) {
  std::vector<std::string> pretoks;
  pretokenize(text, &pretoks);
  for (const auto& w : pretoks) bpe_word(bpe, w, out);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* bpe_load(const char* vocab_path, const char* merges_path) {
  return load_bpe(vocab_path, merges_path);
}

void bpe_free(void* handle) { delete static_cast<BPE*>(handle); }

int32_t bpe_vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<BPE*>(handle)->id_to_token.size());
}

// Returns the id of a token given its RAW BYTES (post-unmapping), -1 if
// absent — lets the Python wrapper resolve special tokens like
// "<|endoftext|>" without duplicating the alphabet mapping.
int32_t bpe_token_id(void* handle, const char* bytes, int64_t len) {
  const auto& vocab = static_cast<BPE*>(handle)->vocab;
  auto it = vocab.find(std::string(bytes, static_cast<size_t>(len)));
  return it == vocab.end() ? -1 : it->second;
}

// Encodes UTF-8 text; returns the total token count (may exceed capacity,
// in which case only the first `capacity` ids were written — caller re-runs
// with a larger buffer).
int64_t bpe_encode(void* handle, const char* text, int32_t* out,
                   int64_t capacity) {
  std::vector<int32_t> ids;
  encode_text(*static_cast<BPE*>(handle), text, &ids);
  const int64_t n = static_cast<int64_t>(ids.size());
  std::memcpy(out, ids.data(),
              sizeof(int32_t) * static_cast<size_t>(std::min(n, capacity)));
  return n;
}

// Decodes ids to raw UTF-8 bytes; returns total byte count (same
// capacity-overflow contract as bpe_encode).
int64_t bpe_decode(void* handle, const int32_t* ids, int64_t n, char* out,
                   int64_t capacity) {
  const auto& table = static_cast<BPE*>(handle)->id_to_token;
  std::string buf;
  for (int64_t j = 0; j < n; ++j) {
    int32_t id = ids[j];
    if (id >= 0 && static_cast<size_t>(id) < table.size()) buf += table[id];
  }
  const int64_t total = static_cast<int64_t>(buf.size());
  std::memcpy(out, buf.data(),
              static_cast<size_t>(std::min(total, capacity)));
  return total;
}

// Thread-pooled batch encode: ids is [n_texts, capacity] int32 row-major
// (truncated per row), lengths[n] the untruncated counts.
void bpe_encode_batch(void* handle, const char** texts, int64_t n_texts,
                      int32_t* ids, int64_t capacity, int64_t* lengths,
                      int32_t n_threads) {
  const BPE& bpe = *static_cast<BPE*>(handle);
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      const int64_t t = next.fetch_add(1);
      if (t >= n_texts) return;
      std::vector<int32_t> row;
      encode_text(bpe, texts[t], &row);
      lengths[t] = static_cast<int64_t>(row.size());
      const size_t m =
          std::min(row.size(), static_cast<size_t>(capacity));
      std::memcpy(ids + t * capacity, row.data(), sizeof(int32_t) * m);
    }
  };
  std::vector<std::thread> pool;
  const int32_t n_workers =
      static_cast<int32_t>(std::min<int64_t>(n_threads, n_texts));
  pool.reserve(static_cast<size_t>(n_workers));
  for (int32_t w = 0; w < n_workers; ++w) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
