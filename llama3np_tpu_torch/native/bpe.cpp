// Native BPE merge core for the SentencePiece-style tokenizer.
//
// Semantics are bit-identical to the Python reference loop (reference
// tokenizer.py:32-52, reproduced in this package's tokenizer.py): repeatedly
// scan left-to-right for the adjacent pair whose concatenation exists in the
// vocab with the strictly greatest score (double compare, matching CPython
// float), merge the leftmost such pair, repeat until no merge applies.
// Unknown code points are dropped during seeding (quirk Q4).
//
// Exposed as a tiny C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::vector<std::string> vocab;
  std::vector<double> scores;
  std::unordered_map<std::string, int32_t> index;  // first occurrence wins
};

}  // namespace

extern "C" {

// blob: concatenated UTF-8 token strings; offsets: n+1 byte offsets into blob.
void* bpe_create(const char* blob, const int64_t* offsets, int32_t n,
                 const double* scores) {
  auto* t = new Tokenizer();
  t->vocab.reserve(n);
  t->scores.assign(scores, scores + n);
  t->index.reserve(n * 2);
  for (int32_t i = 0; i < n; ++i) {
    t->vocab.emplace_back(blob + offsets[i],
                          static_cast<size_t>(offsets[i + 1] - offsets[i]));
    t->index.emplace(t->vocab.back(), i);  // keeps the first duplicate,
                                           // matching list.index semantics
  }
  return t;
}

void bpe_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Returns the number of tokens produced (may exceed out_cap; caller retries
// with a larger buffer — never happens in practice since out_cap >= text cps).
int32_t bpe_encode(void* handle, const char* text, int64_t text_len,
                   int32_t* out, int32_t out_cap) {
  auto* t = static_cast<Tokenizer*>(handle);
  std::vector<int32_t> toks;
  toks.reserve(static_cast<size_t>(text_len));

  // Seed with per-code-point ids (UTF-8 walk == Python str iteration).
  int64_t i = 0;
  while (i < text_len) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    int len = 1;
    if (c >= 0xF0) len = 4;
    else if (c >= 0xE0) len = 3;
    else if (c >= 0xC0) len = 2;
    if (i + len > text_len) len = 1;
    auto it = t->index.find(std::string(text + i, len));
    if (it != t->index.end()) toks.push_back(it->second);
    i += len;
  }

  // Greedy merge loop, leftmost-strictly-greatest order.
  std::string merged;
  while (true) {
    double best_score = -1e10;
    int32_t best_id = -1;
    std::ptrdiff_t best_idx = -1;
    for (size_t j = 0; j + 1 < toks.size(); ++j) {
      const std::string& a = t->vocab[toks[j]];
      const std::string& b = t->vocab[toks[j + 1]];
      merged.assign(a);
      merged.append(b);
      auto it = t->index.find(merged);
      if (it != t->index.end() && t->scores[it->second] > best_score) {
        best_score = t->scores[it->second];
        best_id = it->second;
        best_idx = static_cast<std::ptrdiff_t>(j);
      }
    }
    if (best_idx < 0) break;
    toks[best_idx] = best_id;
    toks.erase(toks.begin() + best_idx + 1);
  }

  int32_t n = static_cast<int32_t>(toks.size());
  if (n > 0 && out_cap > 0) {
    std::memcpy(out, toks.data(),
                static_cast<size_t>(std::min(n, out_cap)) * sizeof(int32_t));
  }
  return n;
}

}  // extern "C"
