// The PyTorch port's copy of native/wordpiece.cc, built with g++ by
// vlbert_tpu_torch/data/native_build.py into vlbert_tpu_torch/_build/
// at first use; tests/test_torch_host_natives.py holds it to the
// original.
//
// ASCII fast-path BERT tokenizer: basic (clean / lowercase / punctuation
// split) + greedy longest-match WordPiece, fused into one call per text.
//
// Parity contract: EXACT token-for-token equality with the pure-Python
// reference-parity implementation (vlbert_tpu/data/tokenization.py, itself
// matching ref external/pytorch_pretrained_bert/tokenization.py) for
// pure-ASCII input. The Python wrapper routes any text containing a
// non-ASCII byte (or NUL) to the Python path, so unicode semantics
// (NFD accent stripping, Zs/Mn/P* categories, CJK spacing) never need to
// be reimplemented here. For ASCII, those reduce to the closed forms
// below: whitespace = {space, \t, \n, \r}; control = C0 minus \t\n\r plus
// DEL; punctuation = the four reference ranges; accent strip = identity.
//
// Why native: the basic tokenizer is per-character Python (unicodedata
// calls per char) on EVERY text — it dominates text-heavy __getitem__
// (GeneralCorpus MLM packing, CC captions) on the host pipeline.
//
// ctypes ABI (no pybind11 in this image):
//   void*  wp_new(const char* vocab_blob, int do_lower,
//                 const char* unk_token, int max_chars)
//     vocab_blob: '\n'-joined "token\tid" pairs (explicit ids: a vocab
//     file with duplicate lines leaves id gaps — Python's load_vocab is
//     last-wins — so line order alone cannot reproduce the mapping)
//   void   wp_free(void* h)
//   int    wp_tokenize(void* h, const char* text, int32_t* out, int cap)
//     returns #ids written; -(needed) if cap too small (caller retries);
//     -1000000000 if the text is not eligible (non-ASCII byte seen).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tok {
  std::unordered_map<std::string, int32_t> vocab;
  bool lower = true;
  int32_t unk_id = 0;
  int max_chars = 100;
};

inline bool is_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}
inline bool is_ctrl(unsigned char c) {  // ASCII C* minus \t\n\r
  return (c < 0x20 && c != '\t' && c != '\n' && c != '\r') || c == 0x7f;
}
inline bool is_punct(unsigned char c) {  // ref tokenization ranges
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

const char* kNeverSplit[] = {"[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"};

constexpr int kNotAscii = -1000000000;

// greedy longest-match WordPiece over one basic token; appends ids
void wordpiece(const Tok& t, const std::string& word,
               std::vector<int32_t>* ids) {
  if ((int)word.size() > t.max_chars) {  // chars == bytes for ASCII
    ids->push_back(t.unk_id);
    return;
  }
  std::vector<int32_t> sub;
  size_t start = 0;
  std::string cand;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      cand.assign(start > 0 ? "##" : "");
      cand.append(word, start, end - start);
      auto it = t.vocab.find(cand);
      if (it != t.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {  // un-matchable word -> single [UNK]
      ids->push_back(t.unk_id);
      return;
    }
    sub.push_back(cur);
    start = end;
  }
  ids->insert(ids->end(), sub.begin(), sub.end());
}

}  // namespace

extern "C" {

void* wp_new(const char* vocab_blob, int do_lower, const char* unk_token,
             int max_chars) {
  auto* t = new Tok;
  t->lower = do_lower != 0;
  t->max_chars = max_chars;
  const char* p = vocab_blob;
  while (p && *p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? (size_t)(nl - p) : strlen(p);
    const char* tab = (const char*)memchr(p, '\t', len);
    if (tab) {
      int32_t id = (int32_t)strtol(tab + 1, nullptr, 10);
      t->vocab[std::string(p, (size_t)(tab - p))] = id;
    }
    if (!nl) break;
    p = nl + 1;
  }
  auto it = t->vocab.find(unk_token);
  if (it == t->vocab.end()) {  // wrapper refuses to build in this case;
    delete t;                  // belt-and-braces: fail loudly, not id 0
    return nullptr;
  }
  t->unk_id = it->second;
  return t;
}

void wp_free(void* h) { delete static_cast<Tok*>(h); }

int wp_tokenize(void* h, const char* text, int32_t* out, int cap) {
  const Tok& t = *static_cast<Tok*>(h);
  std::vector<int32_t> ids;
  std::string word;
  std::vector<std::string> basic;  // post clean/lower/punct-split tokens

  auto flush_word = [&]() {
    if (!word.empty()) {
      basic.push_back(word);
      word.clear();
    }
  };

  // one pass: clean + whitespace split, handling never_split per raw token
  const char* p = text;
  std::string raw;  // current whitespace-delimited raw token (cleaned)
  auto flush_raw = [&]() {
    if (raw.empty()) return;
    bool never = false;
    for (const char* ns : kNeverSplit) {
      if (raw == ns) {
        never = true;
        break;
      }
    }
    if (never) {
      basic.push_back(raw);
    } else {
      for (unsigned char c : raw) {
        if (t.lower && c >= 'A' && c <= 'Z') c = (unsigned char)(c + 32);
        if (is_punct(c)) {
          flush_word();
          basic.emplace_back(1, (char)c);
        } else {
          word.push_back((char)c);
        }
      }
      flush_word();
    }
    raw.clear();
  };

  for (; *p; ++p) {
    unsigned char c = (unsigned char)*p;
    if (c >= 0x80) return kNotAscii;  // (also excludes U+FFFD, multi-byte)
    if (is_ctrl(c)) continue;         // _clean_text drops control chars
    if (is_ws(c)) {
      flush_raw();
    } else {
      raw.push_back((char)c);
    }
  }
  flush_raw();

  for (const auto& w : basic) wordpiece(t, w, &ids);

  if ((int)ids.size() > cap) return -(int)ids.size();
  memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int)ids.size();
}

}  // extern "C"
