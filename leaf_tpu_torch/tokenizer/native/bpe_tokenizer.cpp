// Fast CLIP byte-BPE tokenizer (ASCII fast path).
//
// Native counterpart of leaf_tpu_torch/tokenizer/bpe.py for the attack hot
// loop: every LEAF training step tokenizes up to 2·B·ρ mutated strings
// host-side.  The Python implementation is
// the reference; this library handles the dominant case — ASCII text
// after lower/whitespace cleaning — and the Python wrapper falls back
// to the pure-Python path for anything else.  Parity is pinned by
// tests/test_torch_native.py.
//
// Exposed C ABI (ctypes):
//   void*  bpe_create(const char* merges_path);   // plain-text merges, one per line
//   void   bpe_destroy(void* h);
//   void   bpe_encode_batch(void* h, const char** texts, int n,
//                           int context_length, int32_t* out /*[n*ctx]*/);
//   int    bpe_encode_one(void* h, const char* text, int32_t* out, int cap);
//
// Token-id layout identical to the Python side: 256 byte tokens +
// 256 byte</w> tokens + merges + <start_of_text>/<end_of_text>.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kSot = 49406;
constexpr int kEot = 49407;

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

// GPT-2/CLIP byte→printable-unicode map, as UTF-8 strings, in the
// canonical vocab order (printables first, then shifted bytes).
void BuildByteVocab(std::vector<std::string>* ordered_vocab /*256*/,
                    std::vector<std::string>* byte_to_unicode /*256*/) {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<bool> present(256, false);
  for (int b : bs) present[b] = true;

  auto utf8 = [](int cp) {
    std::string s;
    if (cp < 0x80) {
      s.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      s.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      s.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      s.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
    return s;
  };

  byte_to_unicode->assign(256, "");
  ordered_vocab->clear();
  int shift = 0;
  // the canonical order appends non-printables after the printables
  std::vector<int> order = bs;
  for (int b = 0; b < 256; ++b) {
    if (!present[b]) order.push_back(b);
  }
  std::vector<std::string> mapped(256);
  shift = 0;
  for (int b = 0; b < 256; ++b) {
    if (present[b]) {
      mapped[b] = utf8(b);
    } else {
      mapped[b] = utf8(256 + shift);
      ++shift;
    }
  }
  for (int b : order) ordered_vocab->push_back(mapped[b]);
  *byte_to_unicode = mapped;
}

struct Tokenizer {
  std::unordered_map<std::string, int> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> rank;
  std::vector<std::string> byte_enc;  // byte → unicode utf8 string
  std::unordered_map<std::string, std::vector<int>> cache;

  std::vector<int> BpeIds(const std::string& raw_token) {
    auto it = cache.find(raw_token);
    if (it != cache.end()) return it->second;

    std::vector<std::string> units;
    units.reserve(raw_token.size() + 1);
    for (unsigned char c : raw_token) units.push_back(byte_enc[c]);
    units.back() += "</w>";

    while (units.size() > 1) {
      int best_rank = -1;
      size_t best_i = 0;
      for (size_t i = 0; i + 1 < units.size(); ++i) {
        auto r = rank.find({units[i], units[i + 1]});
        if (r != rank.end() && (best_rank < 0 || r->second < best_rank)) {
          best_rank = r->second;
          best_i = i;
        }
      }
      if (best_rank < 0) break;
      const std::string first = units[best_i];
      const std::string second = units[best_i + 1];
      const std::string merged = first + second;
      std::vector<std::string> out;
      out.reserve(units.size());
      for (size_t i = 0; i < units.size();) {
        if (i + 1 < units.size() && units[i] == first &&
            units[i + 1] == second) {
          out.push_back(merged);
          i += 2;
        } else {
          out.push_back(units[i]);
          ++i;
        }
      }
      units.swap(out);
    }
    std::vector<int> ids;
    ids.reserve(units.size());
    for (const auto& u : units) {
      auto e = encoder.find(u);
      ids.push_back(e == encoder.end() ? 0 : e->second);
    }
    cache.emplace(raw_token, ids);
    return ids;
  }

  // Scanner equivalent of the CLIP word regex for lowercased ASCII:
  //   's|'t|'re|'ve|'m|'ll|'d | [letters]+ | [digit] | [^\s letters digits]+
  void Encode(const char* text, std::vector<int>* out) {
    // lower + whitespace-clean inline
    std::string s(text);
    for (auto& c : s) c = static_cast<char>(std::tolower(
        static_cast<unsigned char>(c)));
    const size_t n = s.size();
    size_t i = 0;
    auto is_sp = [](char c) {
      return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
             c == '\v';
    };
    auto is_al = [](char c) { return c >= 'a' && c <= 'z'; };
    auto is_dg = [](char c) { return c >= '0' && c <= '9'; };
    while (i < n) {
      if (is_sp(s[i])) { ++i; continue; }
      // contractions
      if (s[i] == '\'' && i + 1 < n) {
        size_t len = 0;
        if (i + 2 < n || i + 2 == n) {
          if (n - i >= 3) {
            const char a = s[i + 1], b = s[i + 2];
            if ((a == 'r' && b == 'e') || (a == 'v' && b == 'e') ||
                (a == 'l' && b == 'l'))
              len = 3;
          }
          if (len == 0) {
            const char a = s[i + 1];
            if (a == 's' || a == 't' || a == 'm' || a == 'd') len = 2;
          }
        }
        if (len > 0) {
          const std::string tok = s.substr(i, len);
          auto ids = BpeIds(tok);
          out->insert(out->end(), ids.begin(), ids.end());
          i += len;
          continue;
        }
      }
      size_t j = i;
      if (is_al(s[i])) {
        while (j < n && is_al(s[j])) ++j;
      } else if (is_dg(s[i])) {
        j = i + 1;  // single digit
      } else {
        // symbol run: greedy to the next space/letter/digit — matching
        // the regex alternation, contractions are only tried at the
        // START of a match, so mid-run apostrophes are swallowed
        while (j < n && !is_sp(s[j]) && !is_al(s[j]) && !is_dg(s[j])) ++j;
      }
      const std::string tok = s.substr(i, j - i);
      auto ids = BpeIds(tok);
      out->insert(out->end(), ids.begin(), ids.end());
      i = j;
    }
  }
};

// shared edit application (mirrors attacks/edits.py apply_edit).
// Inserting the slot placeholder '_' at an insertion slot is a
// SELF-SUBSTITUTION (python: chars[z] == ch): a no-op when
// alternative == -1, the alternative character otherwise.
void ApplyEdit(const std::string& S, int z, int cp, int alternative,
               std::string* edited) {
  edited->clear();
  const int L = static_cast<int>(S.size());
  const bool is_char_pos = (z % 2) == 1;
  const int char_idx = is_char_pos ? (z - 1) / 2 : z / 2;
  const int ins = (cp == '_') ? alternative : cp;  // placeholder self-sub
  for (int c = 0; c < L; ++c) {
    if (!is_char_pos && c == char_idx && ins != -1) {
      edited->push_back(static_cast<char>(ins));
    }
    if (is_char_pos && c == char_idx) {
      if (cp == -1) continue;
      const char ch = static_cast<char>(cp);
      if (S[c] == ch && alternative == -1) continue;
      if (S[c] == ch && alternative >= 0) {
        edited->push_back(static_cast<char>(alternative));
      } else {
        edited->push_back(ch);
      }
      continue;
    }
    edited->push_back(S[c]);
  }
  if (!is_char_pos && char_idx == L && ins != -1) {
    edited->push_back(static_cast<char>(ins));
  }
}

}  // namespace

extern "C" {

void* bpe_create(const char* merges_path) {
  auto* t = new Tokenizer();
  std::vector<std::string> ordered, b2u;
  BuildByteVocab(&ordered, &b2u);
  t->byte_enc = b2u;

  int id = 0;
  for (const auto& v : ordered) t->encoder.emplace(v, id++);
  for (const auto& v : ordered) t->encoder.emplace(v + "</w>", id++);

  std::ifstream f(merges_path);
  if (!f.good()) { delete t; return nullptr; }
  std::string line;
  int r = 0;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    const size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    std::string a = line.substr(0, sp);
    std::string b = line.substr(sp + 1);
    if (!b.empty() && b.back() == '\r') b.pop_back();
    t->rank.emplace(std::make_pair(a, b), r++);
    t->encoder.emplace(a + b, id++);
  }
  t->encoder.emplace("<start_of_text>", id++);
  t->encoder.emplace("<end_of_text>", id++);
  return t;
}

void bpe_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

int bpe_encode_one(void* h, const char* text, int32_t* out, int cap) {
  auto* t = static_cast<Tokenizer*>(h);
  std::vector<int> ids;
  t->Encode(text, &ids);
  const int n = static_cast<int>(std::min<size_t>(ids.size(), cap));
  for (int i = 0; i < n; ++i) out[i] = ids[i];
  return static_cast<int>(ids.size());
}

// Fixed-shape batch encode: out is [n, context_length] int32, zero
// padded, SOT + ids + EOT with truncation keeping EOT last.
void bpe_encode_batch(void* h, const char** texts, int n,
                      int context_length, int32_t* out) {
  auto* t = static_cast<Tokenizer*>(h);
  std::vector<int> ids;
  for (int row = 0; row < n; ++row) {
    ids.clear();
    t->Encode(texts[row], &ids);
    int32_t* dst = out + static_cast<size_t>(row) * context_length;
    std::memset(dst, 0, sizeof(int32_t) * context_length);
    const int body = std::min<int>(static_cast<int>(ids.size()),
                                   context_length - 2);
    dst[0] = kSot;
    for (int i = 0; i < body; ++i) dst[1 + i] = ids[i];
    dst[1 + body] = kEot;
  }
}

// Fused Levenshtein-edit + tokenize for the LEAF attack hot loop.
//
// Applies the interleaved-slot single edit (k=1) of
// leaf_tpu_torch/attacks/edits.py::apply_edit to `sentence` for each
// (z, codepoint) pair and tokenizes the result directly — no Python
// string churn.  codepoint == -1 means delete; a self-substitution with
// alternative == -1 also deletes (the attacks' convention).  ASCII
// sentences only (the wrapper guards).
//
//   zs, cps: [n_sent * rho]; out: [n_sent * rho, ctx] int32.
void bpe_encode_edits(void* h, const char** sentences, int n_sent,
                      const int32_t* zs, const int32_t* cps, int rho,
                      int alternative, int ctx, int32_t* out) {
  auto* t = static_cast<Tokenizer*>(h);
  std::string edited;
  std::vector<int> ids;
  for (int i = 0; i < n_sent; ++i) {
    const std::string S(sentences[i]);
    for (int j = 0; j < rho; ++j) {
      const int z = zs[i * rho + j];
      const int cp = cps[i * rho + j];
      // slot layout: [_ c0 _ c1 ... _ c(L-1) _], slot z; even = insert
      // slot, odd = character position (k=1)
      ApplyEdit(S, z, cp, alternative, &edited);
      ids.clear();
      t->Encode(edited.c_str(), &ids);
      int32_t* dst = out + (static_cast<size_t>(i) * rho + j) * ctx;
      std::memset(dst, 0, sizeof(int32_t) * ctx);
      const int body = std::min<int>(static_cast<int>(ids.size()), ctx - 2);
      dst[0] = kSot;
      for (int b = 0; b < body; ++b) dst[1 + b] = ids[b];
      dst[1 + body] = kEot;
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Word-validity constraint (ASCII fast path).
//
// Native counterpart of leaf_tpu_torch/attacks/constraint.py for the
// constrained attack (`--constrain`, the released-model setting): an
// edit is valid iff the count of DISTINCT dictionary words strictly
// decreases.  The scanner mirrors constraint.word_tokenize for
// lowercased ASCII: alnum runs (with an optional 'x contraction tail,
// split off when it is one of 's|'t|'re|'ve|'m|'ll|'d), single
// punctuation chars otherwise.  Parity: tests/test_torch_native.py.
// ---------------------------------------------------------------------------

namespace {

struct WordDict {
  std::unordered_map<std::string, int> words;  // word -> id (for dedup)

  // distinct dictionary words in lowercased ASCII text
  int CountDistinct(const std::string& s, std::vector<int>* seen_ids,
                    int* generation, std::vector<int>* seen_gen) const {
    const size_t n = s.size();
    size_t i = 0;
    int count = 0;
    ++*generation;
    auto is_sp = [](char c) {
      return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
             c == '\v';
    };
    auto is_al = [](char c) { return (c >= 'a' && c <= 'z'); };
    auto is_an = [&](char c) { return is_al(c) || (c >= '0' && c <= '9'); };
    auto check = [&](const std::string& tok) {
      auto it = words.find(tok);
      if (it == words.end()) return;
      const int id = it->second;
      if ((*seen_gen)[id] != *generation) {
        (*seen_gen)[id] = *generation;
        ++count;
      }
    };
    while (i < n) {
      if (is_sp(s[i])) { ++i; continue; }
      if (is_an(s[i])) {
        size_t j = i;
        while (j < n && is_an(s[j])) ++j;
        size_t end = j;
        // optional contraction tail '<letters>
        if (j < n && s[j] == '\'' && j + 1 < n && is_al(s[j + 1])) {
          size_t k = j + 1;
          while (k < n && is_al(s[k])) ++k;
          const std::string tail = s.substr(j + 1, k - j - 1);
          if (tail == "s" || tail == "t" || tail == "re" || tail == "ve" ||
              tail == "m" || tail == "ll" || tail == "d") {
            // contraction splits: word + 'tail (two tokens)
            check(s.substr(i, j - i));
            check(s.substr(j, k - j));
            i = k;
            continue;
          }
          end = k;  // single token word'tail
        }
        check(s.substr(i, end - i));
        i = end;
      } else {
        check(s.substr(i, 1));
        ++i;
      }
    }
    return count;
  }
};


std::string Lower(const std::string& s) {
  std::string out(s);
  for (auto& c : out)
    c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
  return out;
}

}  // namespace

extern "C" {

void* wc_create(const char* words_path) {
  auto* d = new WordDict();
  std::ifstream f(words_path);
  if (!f.good()) { delete d; return nullptr; }
  std::string line;
  int id = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty()) d->words.emplace(line, id++);
  }
  return d;
}

void wc_destroy(void* h) { delete static_cast<WordDict*>(h); }

// out[i*rho + j] = 1 iff edit (zs, cps) on sentences[i] is VALID
// (distinct-dict-word count strictly decreases).
void wc_valid_edits(void* h, const char** sentences, int n_sent,
                    const int32_t* zs, const int32_t* cps, int rho,
                    int alternative, uint8_t* out) {
  auto* d = static_cast<WordDict*>(h);
  std::vector<int> seen_ids;
  std::vector<int> seen_gen(d->words.size(), 0);
  int generation = 0;
  std::string edited;
  for (int i = 0; i < n_sent; ++i) {
    // the edit applies to the ORIGINAL casing (self-substitution is
    // case-sensitive, edits.apply_edit); only count() lowercases
    const std::string S(sentences[i]);
    const int base =
        d->CountDistinct(Lower(S), &seen_ids, &generation, &seen_gen);
    for (int j = 0; j < rho; ++j) {
      ApplyEdit(S, zs[i * rho + j], cps[i * rho + j], alternative, &edited);
      const std::string lowered = Lower(edited);
      const int c =
          d->CountDistinct(lowered, &seen_ids, &generation, &seen_gen);
      out[i * rho + j] = c < base ? 1 : 0;
    }
  }
}

}  // extern "C"
