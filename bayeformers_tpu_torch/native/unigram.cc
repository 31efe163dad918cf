// Native SentencePiece-style Unigram tokenizer for the BayeFormers-TPU
// encoder-decoder and LLaMA-architecture families (models/t5.py,
// models/llama.py, models/whisper.py serving & workloads).
//
// The reference tokenizes through HuggingFace's Python tokenizers
// (`examples/bert_squad.py:146-165` is the pattern); this is a standalone
// C++ implementation of the SentencePiece Unigram scheme used by
// T5/LLaMA/Mistral/Gemma vocabularies: metaspace normalization (optional
// dummy "▁" prefix + ASCII space -> "▁", matching the
// Prepend+Replace normalizer sequence in those models' tokenizer.json; no
// NFKC pass — documented divergence, the vocabularies these models ship are
// already NFKC-normalized text in practice), Viterbi maximum-likelihood
// segmentation over a piece hashmap with the SentencePiece single-node
// guarantee (an unknown single-codepoint step with score min_score - 10.0
// wherever no single-codepoint piece exists), fuse_unk emission, optional
// <0xXX> byte fallback, and lossless decode. Exposed through a minimal
// C ABI consumed via ctypes (no pybind11 in this environment), with a
// thread-pooled batch encoder like wordpiece.cc / bpe.cc.
//
// File consumed is the SentencePiece .vocab export format, parsed natively:
//   vocab.tsv — one "piece<TAB>score" per line; line order is piece id.
// (native/__init__.py::UnigramTokenizer.from_tokenizer_json converts the HF
// tokenizer.json Unigram serialization to this format.)
//
// The DP uses IEEE doubles with a fixed iteration order (start positions
// ascending, piece byte-lengths descending, strict-> improvement) so the
// pure-Python fallback in native/__init__.py is bit-identical; the HF-parity
// tests draw continuous random scores so tie-breaking never matters.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread unigram.cc -o libunigram.so

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <limits>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// UTF-8 (same helpers as wordpiece.cc / bpe.cc)
// ---------------------------------------------------------------------------

size_t cp_len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;  // invalid byte: step one
}

constexpr double kUnkPenalty = 10.0;
const char kMetaspace[] = "\xE2\x96\x81";  // U+2581 LOWER ONE EIGHTH BLOCK

struct Model {
  std::vector<std::string> pieces;          // id -> piece (raw UTF-8)
  std::vector<double> scores;               // id -> log prob
  std::unordered_map<std::string, int32_t> piece_to_id;  // first id wins
  int32_t unk_id = -1;
  // 0 = no dummy prefix; 1 = always prepend (HF Prepend normalizer,
  // LLaMA-style); 2 = prepend unless the text already starts with ' ' or
  // the metaspace (HF Metaspace pre_tokenizer semantics, T5-style — its
  // `!starts_with(replacement)` guard runs AFTER the space replacement).
  int prefix_mode = 1;
  bool byte_fallback = false;
  double min_score = 0.0;
  size_t max_piece_len = 1;
  int32_t byte_ids[256];  // id of "<0xXX>" or -1
};

Model* load_model(const char* path, int unk_id, int add_dummy_prefix,
                  int byte_fallback) {
  std::ifstream fh(path);
  if (!fh.is_open()) return nullptr;
  auto* m = new Model();
  m->unk_id = unk_id;
  m->prefix_mode = add_dummy_prefix;
  m->byte_fallback = byte_fallback != 0;
  for (auto& b : m->byte_ids) b = -1;
  std::string line;
  m->min_score = std::numeric_limits<double>::infinity();
  while (std::getline(fh, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    size_t tab = line.rfind('\t');
    std::string piece = tab == std::string::npos ? line : line.substr(0, tab);
    double score =
        tab == std::string::npos ? 0.0 : std::strtod(line.c_str() + tab + 1, nullptr);
    int32_t id = static_cast<int32_t>(m->pieces.size());
    m->pieces.push_back(piece);
    m->scores.push_back(score);
    m->piece_to_id[piece] = id;  // last id wins for dup pieces (HF parity)
    if (piece.size() > m->max_piece_len) m->max_piece_len = piece.size();
    if (score < m->min_score) m->min_score = score;
    // <0xXX> byte-fallback pieces
    if (piece.size() == 6 && piece[0] == '<' && piece[1] == '0' &&
        piece[2] == 'x' && piece[5] == '>') {
      auto hex = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        return -1;
      };
      int hi = hex(piece[3]), lo = hex(piece[4]);
      if (hi >= 0 && lo >= 0) m->byte_ids[hi * 16 + lo] = id;
    }
  }
  if (m->pieces.empty()) {
    delete m;
    return nullptr;
  }
  if (!std::isfinite(m->min_score)) m->min_score = 0.0;
  return m;
}

// Metaspace normalization: optional "▁" prefix, then ASCII ' ' ->
// "▁" (exactly HF's Prepend("▁") + Replace(" ", "▁")).
std::string normalize(const Model& m, const std::string& text) {
  std::string out;
  out.reserve(text.size() + 4);
  bool prepend = false;
  if (!text.empty()) {
    if (m.prefix_mode == 1) {
      prepend = true;
    } else if (m.prefix_mode == 2) {
      prepend = text[0] != ' ' && text.compare(0, 3, kMetaspace) != 0;
    }
  }
  if (prepend) out += kMetaspace;
  for (char c : text) {
    if (c == ' ') {
      out += kMetaspace;
    } else {
      out.push_back(c);
    }
  }
  return out;
}

// Viterbi over the normalized string. out gets piece ids; unknown
// single-codepoint steps are emitted as unk_id (consecutive runs fused) or,
// with byte_fallback, as the <0xXX> pieces of their UTF-8 bytes.
void encode_norm(const Model& m, const std::string& s,
                 std::vector<int32_t>& out) {
  const size_t n = s.size();
  if (n == 0) return;
  const double ninf = -std::numeric_limits<double>::infinity();
  const double unk_score = m.min_score - kUnkPenalty;
  std::vector<double> best(n + 1, ninf);
  // back[j] = start byte of the winning step into j; back_id[j] = piece id
  // or -1 for an unk step.
  std::vector<int32_t> back(n + 1, -1), back_id(n + 1, -2);
  best[0] = 0.0;
  size_t i = 0;
  while (i < n) {
    if (best[i] == ninf) {  // unreachable (mid-codepoint bytes)
      ++i;
      continue;
    }
    size_t one_cp = cp_len(static_cast<unsigned char>(s[i]));
    if (i + one_cp > n) one_cp = n - i;
    bool has_single = false;
    size_t max_len = m.max_piece_len < n - i ? m.max_piece_len : n - i;
    for (size_t len = max_len; len >= 1; --len) {
      auto it = m.piece_to_id.find(s.substr(i, len));
      if (it == m.piece_to_id.end()) continue;
      if (len == one_cp) has_single = true;
      double sc = best[i] + m.scores[it->second];
      if (sc > best[i + len]) {
        best[i + len] = sc;
        back[i + len] = static_cast<int32_t>(i);
        back_id[i + len] = it->second;
      }
    }
    if (!has_single) {  // SentencePiece single-node guarantee
      double sc = best[i] + unk_score;
      if (sc > best[i + one_cp]) {
        best[i + one_cp] = sc;
        back[i + one_cp] = static_cast<int32_t>(i);
        back_id[i + one_cp] = -1;
      }
    }
    ++i;
  }
  // Walk back, then emit forward with fuse_unk / byte fallback.
  std::vector<std::pair<int32_t, int32_t>> steps;  // (start, piece_id|-1)
  size_t j = n;
  while (j > 0) {
    int32_t b = back[j];
    if (b < 0) return;  // malformed UTF-8 tail: give up cleanly
    steps.emplace_back(b, back_id[j]);
    j = static_cast<size_t>(b);
  }
  bool prev_unk = false;
  for (auto it = steps.rbegin(); it != steps.rend(); ++it) {
    int32_t start = it->first, pid = it->second;
    if (pid >= 0) {
      out.push_back(pid);
      prev_unk = false;
      continue;
    }
    if (m.byte_fallback) {
      size_t len = cp_len(static_cast<unsigned char>(s[start]));
      for (size_t k = 0; k < len && start + k < n; ++k) {
        int32_t bid = m.byte_ids[static_cast<unsigned char>(s[start + k])];
        out.push_back(bid >= 0 ? bid : m.unk_id);
      }
      prev_unk = false;
    } else {
      if (!prev_unk) out.push_back(m.unk_id);
      prev_unk = true;  // fuse_unk
    }
  }
}

int64_t encode(const Model& m, const char* text, int32_t* out, int64_t cap) {
  std::vector<int32_t> ids;
  encode_norm(m, normalize(m, std::string(text)), ids);
  int64_t n = static_cast<int64_t>(ids.size());
  if (n <= cap) std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // namespace

extern "C" {

void* ug_load(const char* path, int unk_id, int add_dummy_prefix,
              int byte_fallback) {
  return load_model(path, unk_id, add_dummy_prefix, byte_fallback);
}

void ug_free(void* handle) { delete static_cast<Model*>(handle); }

int32_t ug_vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<Model*>(handle)->pieces.size());
}

int32_t ug_piece_id(void* handle, const char* piece, int64_t len) {
  auto& m = *static_cast<Model*>(handle);
  auto it = m.piece_to_id.find(std::string(piece, static_cast<size_t>(len)));
  return it == m.piece_to_id.end() ? -1 : it->second;
}

int64_t ug_encode(void* handle, const char* text, int32_t* out, int64_t cap) {
  return encode(*static_cast<Model*>(handle), text, out, cap);
}

// Decode: byte pieces emit their raw byte; other pieces emit their text with
// "▁" -> ' '; one leading space is stripped when add_dummy_prefix.
int64_t ug_decode(void* handle, const int32_t* ids, int64_t n, char* out,
                  int64_t cap) {
  auto& m = *static_cast<Model*>(handle);
  std::string buf;
  std::vector<bool> is_byte(m.pieces.size(), false);
  for (int b = 0; b < 256; ++b) {
    if (m.byte_ids[b] >= 0) is_byte[m.byte_ids[b]] = true;
  }
  for (int64_t k = 0; k < n; ++k) {
    int32_t id = ids[k];
    if (id < 0 || id >= static_cast<int32_t>(m.pieces.size())) continue;
    if (is_byte[id]) {
      // "<0xXX>"
      const std::string& p = m.pieces[id];
      int hi = p[3] <= '9' ? p[3] - '0' : (p[3] | 0x20) - 'a' + 10;
      int lo = p[4] <= '9' ? p[4] - '0' : (p[4] | 0x20) - 'a' + 10;
      buf.push_back(static_cast<char>(hi * 16 + lo));
      continue;
    }
    const std::string& p = m.pieces[id];
    size_t q = 0;
    while (q < p.size()) {
      if (p.compare(q, 3, kMetaspace, 3) == 0) {
        buf.push_back(' ');
        q += 3;
      } else {
        buf.push_back(p[q]);
        ++q;
      }
    }
  }
  size_t off = (m.prefix_mode != 0 && !buf.empty() && buf[0] == ' ') ? 1 : 0;
  int64_t out_n = static_cast<int64_t>(buf.size() - off);
  if (out_n <= cap) std::memcpy(out, buf.data() + off, out_n);
  return out_n;
}

void ug_encode_batch(void* handle, const char** texts, int64_t n_texts,
                     int32_t* ids, int64_t cap, int64_t* lengths,
                     int32_t n_threads) {
  auto& m = *static_cast<Model*>(handle);
  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int32_t>(hw) : 4;
  }
  if (n_threads > n_texts) n_threads = static_cast<int32_t>(n_texts);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_texts) break;
      std::vector<int32_t> row;
      encode_norm(m, normalize(m, std::string(texts[i])), row);
      lengths[i] = static_cast<int64_t>(row.size());
      int64_t take = static_cast<int64_t>(row.size()) < cap
                         ? static_cast<int64_t>(row.size())
                         : cap;
      std::memcpy(ids + i * cap, row.data(), take * sizeof(int32_t));
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
