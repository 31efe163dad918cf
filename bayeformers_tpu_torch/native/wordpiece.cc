// Native WordPiece tokenizer for the BayeFormers-TPU data pipeline.
//
// The reference leans on HuggingFace tokenizers for its GLUE/SQuAD
// featurization (`examples/bert_squad.py:146-165`), which dominated its data
// prep time (minutes of tokenization, cached to disk). This is a standalone
// C++ implementation of BERT-style tokenization — basic tokenizer
// (lowercase, accent folding for Latin-1 ranges, punctuation splitting, CJK
// isolation) followed by greedy longest-match WordPiece — with a thread pool
// for batch encoding. Exposed through a minimal C ABI consumed via ctypes
// (no pybind11 in this environment).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread wordpiece.cc -o libwordpiece.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> token_to_id;
  int32_t unk_id = 100;   // [UNK]
  int32_t cls_id = 101;   // [CLS]
  int32_t sep_id = 102;   // [SEP]
  int32_t pad_id = 0;     // [PAD]
  bool lowercase = true;
  size_t max_input_chars_per_word = 100;
};

// ---------------------------------------------------------------------------
// UTF-8 iteration
// ---------------------------------------------------------------------------

// Decodes the codepoint starting at s[i]; advances i past it.
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

bool is_whitespace(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0xA0 ||
         cp == 0x2009 || cp == 0x200A || cp == 0x202F || cp == 0x3000;
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  return cp < 0x20 || cp == 0x7F || (cp >= 0x80 && cp < 0xA0);
}

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

bool is_punctuation(uint32_t cp) {
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126)) {
    return true;
  }
  // General Punctuation block and CJK symbol ranges commonly hit in text.
  return (cp >= 0x2000 && cp <= 0x206F) || (cp >= 0x3000 && cp <= 0x303F) ||
         (cp >= 0xFF00 && cp <= 0xFF0F) || (cp >= 0xFF1A && cp <= 0xFF20) ||
         (cp >= 0xFF3B && cp <= 0xFF40) || (cp >= 0xFF5B && cp <= 0xFF65);
}

// Lowercase + strip accents for ASCII and Latin-1 Supplement (covers the
// overwhelming majority of GLUE/SQuAD text; other scripts pass through).
uint32_t fold(uint32_t cp, bool lowercase) {
  if (!lowercase) return cp;
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) cp += 32;  // À-Þ -> à-þ
  static const struct { uint32_t lo, hi; char base; } kFold[] = {
      {0xE0, 0xE5, 'a'}, {0xE8, 0xEB, 'e'}, {0xEC, 0xEF, 'i'},
      {0xF2, 0xF6, 'o'}, {0xF9, 0xFC, 'u'}, {0xE7, 0xE7, 'c'},
      {0xF1, 0xF1, 'n'}, {0xFD, 0xFD, 'y'}, {0xFF, 0xFF, 'y'},
  };
  for (const auto& f : kFold) {
    if (cp >= f.lo && cp <= f.hi) return static_cast<uint32_t>(f.base);
  }
  return cp;
}

// Basic tokenization: split on whitespace/punct/CJK, drop control chars.
std::vector<std::string> basic_tokenize(const std::string& text,
                                        bool lowercase) {
  std::vector<std::string> tokens;
  std::string current;
  size_t i = 0;
  while (i < text.size()) {
    uint32_t cp = next_codepoint(text, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) {
      if (!current.empty()) tokens.push_back(std::move(current));
      current.clear();
      continue;
    }
    cp = fold(cp, lowercase);
    if (is_punctuation(cp) || is_cjk(cp)) {
      if (!current.empty()) tokens.push_back(std::move(current));
      current.clear();
      std::string solo;
      append_codepoint(solo, cp);
      tokens.push_back(std::move(solo));
      continue;
    }
    append_codepoint(current, cp);
  }
  if (!current.empty()) tokens.push_back(std::move(current));
  return tokens;
}

// Greedy longest-match WordPiece over one basic token.
void wordpiece(const Vocab& vocab, const std::string& word,
               std::vector<int32_t>* out) {
  if (word.size() > vocab.max_input_chars_per_word) {
    out->push_back(vocab.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur_id = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = vocab.token_to_id.find(sub);
      if (it != vocab.token_to_id.end()) {
        cur_id = it->second;
        break;
      }
      // Back off by whole codepoints, not bytes.
      do {
        --end;
      } while (end > start && (word[end] & 0xC0) == 0x80);
    }
    if (cur_id < 0) {
      out->push_back(vocab.unk_id);
      return;
    }
    pieces.push_back(cur_id);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

void encode_text(const Vocab& vocab, const char* text,
                 std::vector<int32_t>* out) {
  for (const auto& word : basic_tokenize(text, vocab.lowercase)) {
    wordpiece(vocab, word, out);
  }
}

// ---------------------------------------------------------------------------
// Offset-tracking variant: every emitted token id carries the [start, end)
// *codepoint* span of the original text it came from, so Python can slice
// the source string subword-exactly (SQuAD span decoding; the
// word-granularity fallback in utils/squad.py snaps answers to word
// boundaries and mangles punctuation-adjacent answers).
// ---------------------------------------------------------------------------

struct TokenWithMap {
  std::string text;             // normalized token bytes
  std::vector<int32_t> src_cp;  // source codepoint index per normalized cp
};

std::vector<TokenWithMap> basic_tokenize_offsets(const std::string& text,
                                                 bool lowercase) {
  std::vector<TokenWithMap> tokens;
  TokenWithMap current;
  size_t i = 0;
  int32_t cp_index = 0;
  while (i < text.size()) {
    uint32_t cp = next_codepoint(text, i);
    int32_t src = cp_index++;
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) {
      if (!current.text.empty()) tokens.push_back(std::move(current));
      current = TokenWithMap{};
      continue;
    }
    cp = fold(cp, lowercase);
    if (is_punctuation(cp) || is_cjk(cp)) {
      if (!current.text.empty()) tokens.push_back(std::move(current));
      current = TokenWithMap{};
      TokenWithMap solo;
      append_codepoint(solo.text, cp);
      solo.src_cp.push_back(src);
      tokens.push_back(std::move(solo));
      continue;
    }
    append_codepoint(current.text, cp);
    current.src_cp.push_back(src);
  }
  if (!current.text.empty()) tokens.push_back(std::move(current));
  return tokens;
}

void wordpiece_offsets(const Vocab& vocab, const TokenWithMap& tok,
                       std::vector<int32_t>* ids, std::vector<int32_t>* starts,
                       std::vector<int32_t>* ends) {
  const std::string& word = tok.text;
  int32_t word_s = tok.src_cp.front();
  int32_t word_e = tok.src_cp.back() + 1;
  if (word.size() > vocab.max_input_chars_per_word) {
    ids->push_back(vocab.unk_id);
    starts->push_back(word_s);
    ends->push_back(word_e);
    return;
  }
  // byte offset of each codepoint start within `word` (normalized space)
  std::vector<size_t> cp_byte;
  for (size_t b = 0; b < word.size();) {
    cp_byte.push_back(b);
    next_codepoint(word, b);
  }
  size_t start = 0;
  std::vector<int32_t> pids, pstarts, pends;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur_id = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = vocab.token_to_id.find(sub);
      if (it != vocab.token_to_id.end()) {
        cur_id = it->second;
        break;
      }
      do {
        --end;
      } while (end > start && (word[end] & 0xC0) == 0x80);
    }
    if (cur_id < 0) {
      ids->push_back(vocab.unk_id);
      starts->push_back(word_s);
      ends->push_back(word_e);
      return;
    }
    size_t a = std::lower_bound(cp_byte.begin(), cp_byte.end(), start) -
               cp_byte.begin();
    size_t b = std::lower_bound(cp_byte.begin(), cp_byte.end(), end) -
               cp_byte.begin();
    pids.push_back(cur_id);
    pstarts.push_back(tok.src_cp[a]);
    pends.push_back(tok.src_cp[b - 1] + 1);
    start = end;
  }
  ids->insert(ids->end(), pids.begin(), pids.end());
  starts->insert(starts->end(), pstarts.begin(), pstarts.end());
  ends->insert(ends->end(), pends.begin(), pends.end());
}

}  // namespace

extern "C" {

// Loads vocab.txt (one token per line, id = line number). Returns a handle
// or nullptr on failure.
void* wp_load(const char* vocab_path, int lowercase) {
  std::ifstream in(vocab_path);
  if (!in) return nullptr;
  auto* vocab = new Vocab;
  vocab->lowercase = lowercase != 0;
  std::string line;
  int32_t id = 0;
  while (std::getline(in, line)) {
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n')) {
      line.pop_back();
    }
    vocab->token_to_id[line] = id++;  // duplicate entries: last one wins (HF parity)
  }
  auto find = [&](const char* tok, int32_t fallback) {
    auto it = vocab->token_to_id.find(tok);
    return it == vocab->token_to_id.end() ? fallback : it->second;
  };
  vocab->unk_id = find("[UNK]", 100);
  vocab->cls_id = find("[CLS]", 101);
  vocab->sep_id = find("[SEP]", 102);
  vocab->pad_id = find("[PAD]", 0);
  return vocab;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

int32_t wp_vocab_size(void* handle) {
  return static_cast<int32_t>(
      static_cast<Vocab*>(handle)->token_to_id.size());
}

int32_t wp_special_id(void* handle, const char* name) {
  auto* vocab = static_cast<Vocab*>(handle);
  std::string n(name);
  if (n == "unk") return vocab->unk_id;
  if (n == "cls") return vocab->cls_id;
  if (n == "sep") return vocab->sep_id;
  if (n == "pad") return vocab->pad_id;
  return -1;
}

// Encodes one text (no special tokens). Writes at most `capacity` ids into
// `out`; returns the number of ids produced (may exceed capacity to signal
// truncation).
int64_t wp_encode(void* handle, const char* text, int32_t* out,
                  int64_t capacity) {
  auto* vocab = static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  encode_text(*vocab, text, &ids);
  int64_t n = static_cast<int64_t>(ids.size());
  std::memcpy(out, ids.data(),
              sizeof(int32_t) * std::min<int64_t>(n, capacity));
  return n;
}

// Encodes one text with per-token [start, end) codepoint offsets into the
// original string. Writes at most `capacity` entries into each array;
// returns the number of tokens produced (may exceed capacity to signal
// truncation).
int64_t wp_encode_offsets(void* handle, const char* text, int32_t* out_ids,
                          int32_t* out_starts, int32_t* out_ends,
                          int64_t capacity) {
  auto* vocab = static_cast<Vocab*>(handle);
  std::vector<int32_t> ids, starts, ends;
  for (const auto& tok : basic_tokenize_offsets(text, vocab->lowercase)) {
    wordpiece_offsets(*vocab, tok, &ids, &starts, &ends);
  }
  int64_t n = static_cast<int64_t>(ids.size());
  int64_t m = std::min<int64_t>(n, capacity);
  std::memcpy(out_ids, ids.data(), sizeof(int32_t) * m);
  std::memcpy(out_starts, starts.data(), sizeof(int32_t) * m);
  std::memcpy(out_ends, ends.data(), sizeof(int32_t) * m);
  return n;
}

// Batch-encodes `count` texts in parallel. Each row of `out` holds
// `capacity` ids; `lengths[i]` receives the true length of text i.
void wp_encode_batch(void* handle, const char** texts, int64_t count,
                     int32_t* out, int64_t capacity, int64_t* lengths,
                     int32_t n_threads) {
  auto* vocab = static_cast<Vocab*>(handle);
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  std::vector<std::thread> workers;
  std::atomic_int64_t next{0};
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= count) return;
      std::vector<int32_t> ids;
      encode_text(*vocab, texts[i], &ids);
      lengths[i] = static_cast<int64_t>(ids.size());
      std::memcpy(out + i * capacity, ids.data(),
                  sizeof(int32_t) *
                      std::min<int64_t>(static_cast<int64_t>(ids.size()),
                                        capacity));
    }
  };
  for (int32_t t = 0; t < n_threads; ++t) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

}  // extern "C"
