// Native runtime components for k8s_llm_rca_tpu_torch (a copy of the repo's
// csrc/native.cpp, built by k8s_llm_rca_tpu_torch/native/__init__.py).
//
// Two host-side hot paths of the serving runtime, exposed through a plain C
// ABI for ctypes (the environment ships no pybind11):
//
// 1. Page allocator — the paged KV cache's single owner of page ids.  Under
//    continuous batching every admission/growth/retirement goes through it;
//    the C++ version keeps the same invariants as engine/paged.PageAllocator
//    (no double free, no cross-owner free, exact leak accounting) and is
//    drop-in behind the same Python interface.
//
// 2. JSON grammar engine — the character-level pushdown automaton of
//    engine/constrain.py plus the token-mask computation.  The mask step
//    simulates every vocab token's characters from the current state; in
//    Python that is O(V * len) interpreter work per decode tick (tens of
//    milliseconds at 32k-token vocabs), here it is a tight loop over a
//    flattened vocab buffer.
//
// Semantics intentionally mirror the Python implementations one-to-one;
// tests/test_torch_tiers.py asserts parity on both components.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// status codes shared by both components
// ---------------------------------------------------------------------------

enum Status : int32_t {
  OK = 0,
  ERR_OUT_OF_PAGES = 1,
  ERR_DOUBLE_FREE = 2,
  ERR_FOREIGN_PAGE = 3,
  ERR_TRASH_PAGE = 4,
  ERR_LEAK = 5,
  ERR_BAD_ARG = 6,
  ERR_GRAMMAR_VIOLATION = 7,
};

// ---------------------------------------------------------------------------
// 1. page allocator
// ---------------------------------------------------------------------------

struct PageAlloc {
  int32_t n_pages;
  std::vector<int32_t> free_list;
  std::unordered_map<int32_t, int64_t> owner;  // page -> owner tag
};

void* pagealloc_create(int32_t n_pages) {
  if (n_pages < 2) return nullptr;
  auto* a = new PageAlloc();
  a->n_pages = n_pages;
  a->free_list.reserve(n_pages - 1);
  for (int32_t p = 1; p < n_pages; ++p) a->free_list.push_back(p);
  return a;
}

void pagealloc_destroy(void* h) { delete static_cast<PageAlloc*>(h); }

int32_t pagealloc_n_free(void* h) {
  return static_cast<int32_t>(static_cast<PageAlloc*>(h)->free_list.size());
}

int32_t pagealloc_alloc(void* h, int32_t n, int64_t owner_tag,
                        int32_t* out_pages) {
  auto* a = static_cast<PageAlloc*>(h);
  if (n < 0) return ERR_BAD_ARG;
  if (n > static_cast<int32_t>(a->free_list.size())) return ERR_OUT_OF_PAGES;
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = a->free_list.back();
    a->free_list.pop_back();
    a->owner[p] = owner_tag;
    out_pages[i] = p;
  }
  return OK;
}

int32_t pagealloc_free(void* h, const int32_t* pages, int32_t n,
                       int64_t owner_tag) {
  auto* a = static_cast<PageAlloc*>(h);
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p == 0) return ERR_TRASH_PAGE;
    auto it = a->owner.find(p);
    if (it == a->owner.end()) return ERR_DOUBLE_FREE;
    if (it->second != owner_tag) return ERR_FOREIGN_PAGE;
    a->owner.erase(it);
    a->free_list.push_back(p);
  }
  return OK;
}

int32_t pagealloc_transfer(void* h, const int32_t* pages, int32_t n,
                           int64_t from_owner, int64_t to_owner) {
  auto* a = static_cast<PageAlloc*>(h);
  // validate all pages first so a failed transfer changes nothing
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p == 0) return ERR_TRASH_PAGE;
    auto it = a->owner.find(p);
    if (it == a->owner.end()) return ERR_DOUBLE_FREE;
    if (it->second != from_owner) return ERR_FOREIGN_PAGE;
  }
  for (int32_t i = 0; i < n; ++i) a->owner[pages[i]] = to_owner;
  return OK;
}

int32_t pagealloc_pages_of(void* h, int64_t owner_tag, int32_t* out,
                           int32_t cap) {
  auto* a = static_cast<PageAlloc*>(h);
  int32_t n = 0;
  for (const auto& kv : a->owner) {
    if (kv.second == owner_tag) {
      if (n < cap) out[n] = kv.first;
      ++n;
    }
  }
  return n;
}

int32_t pagealloc_check(void* h) {
  auto* a = static_cast<PageAlloc*>(h);
  std::vector<uint8_t> seen(a->n_pages, 0);
  for (int32_t p : a->free_list) {
    if (p <= 0 || p >= a->n_pages || seen[p]) return ERR_LEAK;
    seen[p] = 1;
  }
  for (const auto& kv : a->owner) {
    int32_t p = kv.first;
    if (p <= 0 || p >= a->n_pages || seen[p]) return ERR_LEAK;
    seen[p] = 1;
  }
  for (int32_t p = 1; p < a->n_pages; ++p)
    if (!seen[p]) return ERR_LEAK;
  return OK;
}

// ---------------------------------------------------------------------------
// 2. JSON grammar engine (mirror of engine/constrain.JsonCharAutomaton)
// ---------------------------------------------------------------------------

enum JState : int32_t {
  S_VALUE, S_ARR_VALUE_OR_END, S_OBJ_KEY_OR_END, S_OBJ_KEY,
  S_STR, S_KEY, S_STR_ESC, S_KEY_ESC, S_STR_HEX, S_KEY_HEX,
  S_COLON, S_AFTER_VALUE, S_LIT,
  S_NUM_MINUS, S_NUM_ZERO, S_NUM_INT, S_NUM_FRAC_START, S_NUM_FRAC,
  S_NUM_EXP_START, S_NUM_EXP_SIGN, S_NUM_EXP, S_TRAILING,
};

static inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}
static inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
static inline bool is_hex(char c) {
  return is_digit(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F');
}
// legal unescaped string chars: printable ASCII minus '"' and '\\'
// (non-ASCII excluded so byte vocabs can't split codepoints; matches
// _STRING_CHARS in engine/constrain.py)
static inline bool is_str_char(char c) {
  unsigned char u = static_cast<unsigned char>(c);
  return u >= 0x20 && u < 0x7F && c != '"' && c != '\\';
}

struct JsonAuto {
  std::vector<uint8_t> stack;  // 1 = obj, 2 = arr
  int32_t state = S_VALUE;
  const char* lit = nullptr;   // "true" / "false" / "null"
  int32_t lit_len = 0;
  int32_t lit_pos = 0;
  int32_t hex_left = 0;
  bool complete = false;

  void end_value() {
    if (stack.empty()) {
      complete = true;
      state = S_TRAILING;
    } else {
      state = S_AFTER_VALUE;
    }
  }

  bool can_terminate() const {
    return complete ||
           (stack.empty() &&
            (state == S_NUM_ZERO || state == S_NUM_INT ||
             state == S_NUM_FRAC || state == S_NUM_EXP));
  }

  bool delim_ok(char c) const {
    if (is_ws(c)) return true;
    if (stack.empty()) return false;
    return stack.back() == 1 ? (c == ',' || c == '}') : (c == ',' || c == ']');
  }

  bool accept(char c) {
    switch (state) {
      case S_VALUE:
        if (is_ws(c)) return true;
        if (c == '{') { stack.push_back(1); state = S_OBJ_KEY_OR_END; return true; }
        if (c == '[') { stack.push_back(2); state = S_ARR_VALUE_OR_END; return true; }
        if (c == '"') { state = S_STR; return true; }
        if (c == '-') { state = S_NUM_MINUS; return true; }
        if (c == '0') { state = S_NUM_ZERO; return true; }
        if (c >= '1' && c <= '9') { state = S_NUM_INT; return true; }
        if (c == 't') { lit = "true"; lit_len = 4; lit_pos = 1; state = S_LIT; return true; }
        if (c == 'f') { lit = "false"; lit_len = 5; lit_pos = 1; state = S_LIT; return true; }
        if (c == 'n') { lit = "null"; lit_len = 4; lit_pos = 1; state = S_LIT; return true; }
        return false;
      case S_ARR_VALUE_OR_END:
        if (is_ws(c)) return true;
        if (c == ']') { stack.pop_back(); end_value(); return true; }
        state = S_VALUE;
        if (accept(c)) return true;
        state = S_ARR_VALUE_OR_END;
        return false;
      case S_OBJ_KEY_OR_END:
        if (is_ws(c)) return true;
        if (c == '}') { stack.pop_back(); end_value(); return true; }
        if (c == '"') { state = S_KEY; return true; }
        return false;
      case S_OBJ_KEY:
        if (is_ws(c)) return true;
        if (c == '"') { state = S_KEY; return true; }
        return false;
      case S_STR:
      case S_KEY:
        if (c == '"') {
          if (state == S_KEY) state = S_COLON;
          else end_value();
          return true;
        }
        if (c == '\\') { state = (state == S_STR) ? S_STR_ESC : S_KEY_ESC; return true; }
        return is_str_char(c);
      case S_STR_ESC:
      case S_KEY_ESC: {
        int32_t base = (state == S_STR_ESC) ? S_STR : S_KEY;
        if (c == 'u') { hex_left = 4; state = (base == S_STR) ? S_STR_HEX : S_KEY_HEX; return true; }
        if (c == '"' || c == '\\' || c == '/' || c == 'b' || c == 'f' ||
            c == 'n' || c == 'r' || c == 't') { state = base; return true; }
        return false;
      }
      case S_STR_HEX:
      case S_KEY_HEX:
        if (is_hex(c)) {
          if (--hex_left == 0) state = (state == S_STR_HEX) ? S_STR : S_KEY;
          return true;
        }
        return false;
      case S_COLON:
        if (is_ws(c)) return true;
        if (c == ':') { state = S_VALUE; return true; }
        return false;
      case S_AFTER_VALUE: {
        if (is_ws(c)) return true;
        uint8_t top = stack.back();
        if (c == ',') { state = (top == 1) ? S_OBJ_KEY : S_VALUE; return true; }
        if (c == '}' && top == 1) { stack.pop_back(); end_value(); return true; }
        if (c == ']' && top == 2) { stack.pop_back(); end_value(); return true; }
        return false;
      }
      case S_LIT:
        if (lit_pos < lit_len && c == lit[lit_pos]) {
          if (++lit_pos == lit_len) end_value();
          return true;
        }
        return false;
      case S_TRAILING:
        return is_ws(c);
      // ---- numbers (strict JSON grammar)
      case S_NUM_MINUS:
        if (c == '0') { state = S_NUM_ZERO; return true; }
        if (c >= '1' && c <= '9') { state = S_NUM_INT; return true; }
        return false;
      case S_NUM_ZERO:
      case S_NUM_INT:
      case S_NUM_FRAC:
      case S_NUM_EXP: {
        if (state == S_NUM_INT && is_digit(c)) return true;
        if (state == S_NUM_FRAC && is_digit(c)) return true;
        if (state == S_NUM_EXP && is_digit(c)) return true;
        if ((state == S_NUM_ZERO || state == S_NUM_INT) && c == '.') {
          state = S_NUM_FRAC_START; return true;
        }
        if ((state == S_NUM_ZERO || state == S_NUM_INT ||
             state == S_NUM_FRAC) && (c == 'e' || c == 'E')) {
          state = S_NUM_EXP_START; return true;
        }
        if (delim_ok(c)) {
          end_value();
          if (is_ws(c)) return true;
          return accept(c);  // re-dispatch ',' '}' ']'
        }
        return false;
      }
      case S_NUM_FRAC_START:
        if (is_digit(c)) { state = S_NUM_FRAC; return true; }
        return false;
      case S_NUM_EXP_START:
        if (c == '+' || c == '-') { state = S_NUM_EXP_SIGN; return true; }
        if (is_digit(c)) { state = S_NUM_EXP; return true; }
        return false;
      case S_NUM_EXP_SIGN:
        if (is_digit(c)) { state = S_NUM_EXP; return true; }
        return false;
    }
    return false;
  }

  char closing_char() const {
    switch (state) {
      case S_VALUE: case S_NUM_MINUS: case S_NUM_FRAC_START:
      case S_NUM_EXP_START: case S_NUM_EXP_SIGN:
      case S_STR_HEX: case S_KEY_HEX:
        return '0';
      case S_ARR_VALUE_OR_END: return ']';
      case S_OBJ_KEY_OR_END: return '}';
      case S_OBJ_KEY: case S_STR: case S_KEY: return '"';
      case S_STR_ESC: case S_KEY_ESC: return 'n';
      case S_COLON: return ':';
      case S_AFTER_VALUE:
        return stack.back() == 1 ? '}' : ']';
      case S_LIT: return lit[lit_pos];
      case S_NUM_ZERO: case S_NUM_INT: case S_NUM_FRAC: case S_NUM_EXP:
        return stack.back() == 1 ? '}' : ']';
    }
    return 0;
  }
};

struct JsonGrammarEngine {
  JsonAuto fsm;
  // flattened vocab: strings[i] = vocab_buf[offsets[i] .. offsets[i+1])
  std::string vocab_buf;
  std::vector<int32_t> offsets;
  int32_t vocab_size = 0;
};

void* jsongram_create() { return new JsonGrammarEngine(); }
void jsongram_destroy(void* h) { delete static_cast<JsonGrammarEngine*>(h); }

int32_t jsongram_set_vocab(void* h, const char* buf, const int32_t* offsets,
                           int32_t vocab_size) {
  auto* g = static_cast<JsonGrammarEngine*>(h);
  if (vocab_size < 0) return ERR_BAD_ARG;
  g->vocab_size = vocab_size;
  g->offsets.assign(offsets, offsets + vocab_size + 1);
  g->vocab_buf.assign(buf, g->offsets[vocab_size]);
  return OK;
}

int32_t jsongram_complete(void* h) {
  return static_cast<JsonGrammarEngine*>(h)->fsm.complete ? 1 : 0;
}

int32_t jsongram_can_terminate(void* h) {
  return static_cast<JsonGrammarEngine*>(h)->fsm.can_terminate() ? 1 : 0;
}

// Fill out_mask[vocab_size] with 1 where the token is a legal continuation.
// Pure-whitespace tokens are excluded (JSON never requires whitespace).
// Returns the number of allowed tokens.
int32_t jsongram_mask(void* h, uint8_t* out_mask) {
  auto* g = static_cast<JsonGrammarEngine*>(h);
  int32_t n_allowed = 0;
  for (int32_t t = 0; t < g->vocab_size; ++t) {
    const char* s = g->vocab_buf.data() + g->offsets[t];
    int32_t len = g->offsets[t + 1] - g->offsets[t];
    uint8_t ok = 0;
    if (len > 0) {
      bool all_ws = true;
      for (int32_t i = 0; i < len; ++i)
        if (!is_ws(s[i])) { all_ws = false; break; }
      if (!all_ws) {
        JsonAuto sim = g->fsm;  // value copy
        ok = 1;
        for (int32_t i = 0; i < len; ++i)
          if (!sim.accept(s[i])) { ok = 0; break; }
      }
    }
    out_mask[t] = ok;
    n_allowed += ok;
  }
  return n_allowed;
}

int32_t jsongram_advance_token(void* h, int32_t token) {
  auto* g = static_cast<JsonGrammarEngine*>(h);
  if (token < 0 || token >= g->vocab_size) return ERR_BAD_ARG;
  const char* s = g->vocab_buf.data() + g->offsets[token];
  int32_t len = g->offsets[token + 1] - g->offsets[token];
  for (int32_t i = 0; i < len; ++i)
    if (!g->fsm.accept(s[i])) return ERR_GRAMMAR_VIOLATION;
  return OK;
}

int32_t jsongram_accept_char(void* h, char c) {
  return static_cast<JsonGrammarEngine*>(h)->fsm.accept(c) ? OK
                                                           : ERR_GRAMMAR_VIOLATION;
}

// Write the minimal completion into out (cap bytes); returns its length,
// or -1 if cap is too small.
int32_t jsongram_minimal_completion(void* h, char* out, int32_t cap) {
  auto* g = static_cast<JsonGrammarEngine*>(h);
  JsonAuto sim = g->fsm;
  int32_t n = 0;
  while (!sim.complete && !sim.can_terminate()) {
    char c = sim.closing_char();
    if (c == 0 || !sim.accept(c)) return -1;  // unreachable by construction
    if (n >= cap) return -1;
    out[n++] = c;
  }
  return n;
}

}  // extern "C"
