// Native JSONL record loader (the PyTorch port's own copy of the JAX
// package's native/jsonl_loader.cc; the two must parse alike).
//
// The reference delegates data loading to `datasets.load_dataset('json')`
// (reference train-torchrun.py:153-159), whose hot path is Arrow's C++
// JSON reader.  This is the equivalent: a small C++ parser for
// line-delimited JSON records that the port's data layer
// (data/dataset.py) uses for JSONL corpus files.  Lines it rejects go
// through the Python json.loads path, which has the same semantics.
//
// Scope: one JSON *object* per line (the JSONL the summarization corpora
// use).  String values are unescaped here (including \uXXXX surrogate
// pairs -> UTF-8); non-string values (numbers, bools, null, nested
// arrays/objects) are returned as raw JSON text tagged kind=1 for the
// Python side to json.loads on demand — flat string records never touch
// Python's parser at all.
//
// ABI: everything is packed into contiguous arrays (one arena of bytes +
// offset/length arrays indexed per field, plus a per-record field-range
// array), so the ctypes wrapper does O(1) pointer reads per *load*, not
// per field.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed {
  std::string arena;             // all key/value bytes, concatenated
  std::vector<int64_t> rec_start;  // n_records+1 entries into field arrays
  std::vector<int64_t> key_off, key_len, val_off, val_len;
  std::vector<int8_t> kind;      // 0 = string (unescaped), 1 = raw JSON text
  std::string error;             // non-empty => load failed
};

struct Cursor {
  const char* p;
  const char* end;
  int64_t line;  // 1-based, for error messages
};

void skip_ws(Cursor& c) {
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) c.p++;
}

bool fail(Parsed& out, const Cursor& c, const char* msg) {
  char buf[160];
  snprintf(buf, sizeof(buf), "line %lld: %s", static_cast<long long>(c.line), msg);
  out.error = buf;
  return false;
}

// Appends the UTF-8 encoding of `cp` to `arena`.
void utf8_append(std::string& arena, uint32_t cp) {
  if (cp <= 0x7F) {
    arena.push_back(static_cast<char>(cp));
  } else if (cp <= 0x7FF) {
    arena.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    arena.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp <= 0xFFFF) {
    arena.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    arena.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    arena.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    arena.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    arena.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    arena.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    arena.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Strict UTF-8 well-formedness (RFC 3629: continuation ranges, no
// overlongs, no surrogates, max U+10FFFF).  Invalid bytes must fail at
// PARSE time — past load, the Python fallback can no longer engage and a
// bad byte would surface as UnicodeDecodeError at record-access time.
bool utf8_valid(const unsigned char* s, size_t n) {
  size_t i = 0;
  while (i < n) {
    unsigned char b = s[i];
    if (b < 0x80) {
      i++;
    } else if (b >= 0xC2 && b <= 0xDF) {
      if (i + 1 >= n || (s[i + 1] & 0xC0) != 0x80) return false;
      i += 2;
    } else if (b == 0xE0) {
      if (i + 2 >= n || s[i + 1] < 0xA0 || s[i + 1] > 0xBF || (s[i + 2] & 0xC0) != 0x80) return false;
      i += 3;
    } else if ((b >= 0xE1 && b <= 0xEC) || b == 0xEE || b == 0xEF) {
      if (i + 2 >= n || (s[i + 1] & 0xC0) != 0x80 || (s[i + 2] & 0xC0) != 0x80) return false;
      i += 3;
    } else if (b == 0xED) {  // exclude surrogates U+D800..U+DFFF
      if (i + 2 >= n || s[i + 1] < 0x80 || s[i + 1] > 0x9F || (s[i + 2] & 0xC0) != 0x80) return false;
      i += 3;
    } else if (b == 0xF0) {
      if (i + 3 >= n || s[i + 1] < 0x90 || s[i + 1] > 0xBF || (s[i + 2] & 0xC0) != 0x80 ||
          (s[i + 3] & 0xC0) != 0x80)
        return false;
      i += 4;
    } else if (b >= 0xF1 && b <= 0xF3) {
      if (i + 3 >= n || (s[i + 1] & 0xC0) != 0x80 || (s[i + 2] & 0xC0) != 0x80 ||
          (s[i + 3] & 0xC0) != 0x80)
        return false;
      i += 4;
    } else if (b == 0xF4) {  // cap at U+10FFFF
      if (i + 3 >= n || s[i + 1] < 0x80 || s[i + 1] > 0x8F || (s[i + 2] & 0xC0) != 0x80 ||
          (s[i + 3] & 0xC0) != 0x80)
        return false;
      i += 4;
    } else {
      return false;  // 0x80-0xC1 (stray continuation / overlong), 0xF5+
    }
  }
  return true;
}

int hex_val(char ch) {
  if (ch >= '0' && ch <= '9') return ch - '0';
  if (ch >= 'a' && ch <= 'f') return ch - 'a' + 10;
  if (ch >= 'A' && ch <= 'F') return ch - 'A' + 10;
  return -1;
}

bool parse_u16(Cursor& c, Parsed& out, uint32_t* v) {
  if (c.end - c.p < 4) return fail(out, c, "truncated \\u escape");
  uint32_t x = 0;
  for (int i = 0; i < 4; i++) {
    int h = hex_val(c.p[i]);
    if (h < 0) return fail(out, c, "bad hex digit in \\u escape");
    x = (x << 4) | static_cast<uint32_t>(h);
  }
  c.p += 4;
  *v = x;
  return true;
}

// Parses a JSON string (cursor on the opening quote); appends the decoded
// bytes to out.arena and records [off, len).
bool parse_string(Cursor& c, Parsed& out, int64_t* off, int64_t* len) {
  if (*c.p != '"') return fail(out, c, "expected string");
  c.p++;
  *off = static_cast<int64_t>(out.arena.size());
  while (c.p < c.end) {
    unsigned char ch = static_cast<unsigned char>(*c.p);
    if (ch == '"') {
      c.p++;
      *len = static_cast<int64_t>(out.arena.size()) - *off;
      // escape-decoded bytes are valid by construction; raw bytes copied
      // from the input may not be — validate the completed value once
      if (!utf8_valid(
              reinterpret_cast<const unsigned char*>(out.arena.data()) + *off,
              static_cast<size_t>(*len)))
        return fail(out, c, "invalid UTF-8 in string");
      return true;
    }
    if (ch == '\\') {
      c.p++;
      if (c.p >= c.end) return fail(out, c, "truncated escape");
      char e = *c.p++;
      switch (e) {
        case '"': out.arena.push_back('"'); break;
        case '\\': out.arena.push_back('\\'); break;
        case '/': out.arena.push_back('/'); break;
        case 'b': out.arena.push_back('\b'); break;
        case 'f': out.arena.push_back('\f'); break;
        case 'n': out.arena.push_back('\n'); break;
        case 'r': out.arena.push_back('\r'); break;
        case 't': out.arena.push_back('\t'); break;
        case 'u': {
          uint32_t cp;
          if (!parse_u16(c, out, &cp)) return false;
          if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
            if (c.end - c.p >= 6 && c.p[0] == '\\' && c.p[1] == 'u') {
              c.p += 2;
              uint32_t lo;
              if (!parse_u16(c, out, &lo)) return false;
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              } else {
                return fail(out, c, "unpaired surrogate in \\u escape");
              }
            } else {
              return fail(out, c, "unpaired surrogate in \\u escape");
            }
          } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
            // a lone LOW surrogate would encode as invalid UTF-8 and blow
            // up at record-access time, past the Python-fallback window —
            // reject at parse time like the lone-high case
            return fail(out, c, "unpaired surrogate in \\u escape");
          }
          utf8_append(out.arena, cp);
          break;
        }
        default:
          return fail(out, c, "unknown escape character");
      }
      continue;
    }
    if (ch == '\n') return fail(out, c, "unescaped newline inside string");
    out.arena.push_back(static_cast<char>(ch));
    c.p++;
  }
  return fail(out, c, "unterminated string");
}

// Shallow validity check for a raw (non-string) value: exact keyword, a
// well-formed number, or a container (whose innards json.loads re-checks
// lazily on the Python side when the field is actually read).
bool valid_raw(const char* s, const char* end) {
  size_t n = static_cast<size_t>(end - s);
  if (n == 0) return false;
  if (*s == '{' || *s == '[') return true;
  if (n == 4 && memcmp(s, "true", 4) == 0) return true;
  if (n == 4 && memcmp(s, "null", 4) == 0) return true;
  if (n == 5 && memcmp(s, "false", 5) == 0) return true;
  // number: -?int(.frac)?((e|E)(+|-)?digits)?
  const char* p = s;
  if (p < end && *p == '-') p++;
  const char* digits0 = p;
  while (p < end && *p >= '0' && *p <= '9') p++;
  if (p == digits0) return false;
  if (p < end && *p == '.') {
    p++;
    const char* frac0 = p;
    while (p < end && *p >= '0' && *p <= '9') p++;
    if (p == frac0) return false;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    p++;
    if (p < end && (*p == '+' || *p == '-')) p++;
    const char* exp0 = p;
    while (p < end && *p >= '0' && *p <= '9') p++;
    if (p == exp0) return false;
  }
  return p == end;
}

// Raw-scans one non-string JSON value (number/true/false/null/array/object)
// verbatim into the arena.  Balanced-bracket scan that respects strings.
bool parse_raw(Cursor& c, Parsed& out, int64_t* off, int64_t* len) {
  *off = static_cast<int64_t>(out.arena.size());
  const char* start = c.p;
  int depth = 0;
  bool in_str = false;
  while (c.p < c.end) {
    char ch = *c.p;
    if (in_str) {
      if (ch == '\\') {
        if (c.p + 2 > c.end) return fail(out, c, "truncated escape");
        if (c.p[1] == '\n') return fail(out, c, "unescaped newline inside string");
        c.p += 2;
        continue;
      }
      if (ch == '"') in_str = false;
      if (ch == '\n') return fail(out, c, "unescaped newline inside string");
      c.p++;
      continue;
    }
    if (ch == '"') {
      in_str = true;
      c.p++;
      continue;
    }
    if (ch == '{' || ch == '[') depth++;
    if (ch == '}' || ch == ']') {
      if (depth == 0) break;  // the enclosing object's '}' or a bare ']' — stop
      depth--;
    }
    if (depth == 0 && (ch == ',' || ch == '\n')) break;
    c.p++;
  }
  // trim trailing whitespace from the raw slice
  const char* stop = c.p;
  while (stop > start && (stop[-1] == ' ' || stop[-1] == '\t' || stop[-1] == '\r')) stop--;
  if (stop == start) return fail(out, c, "empty value");
  if (!valid_raw(start, stop)) return fail(out, c, "invalid JSON value");
  out.arena.append(start, static_cast<size_t>(stop - start));
  *len = static_cast<int64_t>(out.arena.size()) - *off;
  return true;
}

// Parses one `{...}` object (cursor on '{'); records fields into `out`.
bool parse_object(Cursor& c, Parsed& out) {
  if (*c.p != '{') return fail(out, c, "expected '{' at record start");
  c.p++;
  skip_ws(c);
  if (c.p < c.end && *c.p == '}') {
    c.p++;
    return true;
  }
  while (true) {
    skip_ws(c);
    int64_t ko, kl;
    if (c.p >= c.end) return fail(out, c, "truncated record");
    if (!parse_string(c, out, &ko, &kl)) return false;
    skip_ws(c);
    if (c.p >= c.end || *c.p != ':') return fail(out, c, "expected ':'");
    c.p++;
    skip_ws(c);
    if (c.p >= c.end) return fail(out, c, "truncated record");
    int64_t vo, vl;
    int8_t kind;
    if (*c.p == '"') {
      if (!parse_string(c, out, &vo, &vl)) return false;
      kind = 0;
    } else {
      if (!parse_raw(c, out, &vo, &vl)) return false;
      kind = 1;
    }
    out.key_off.push_back(ko);
    out.key_len.push_back(kl);
    out.val_off.push_back(vo);
    out.val_len.push_back(vl);
    out.kind.push_back(kind);
    skip_ws(c);
    if (c.p >= c.end) return fail(out, c, "truncated record");
    if (*c.p == ',') {
      c.p++;
      continue;
    }
    if (*c.p == '}') {
      c.p++;
      return true;
    }
    return fail(out, c, "expected ',' or '}'");
  }
}

}  // namespace

extern "C" {

struct DllmJsonl {
  Parsed* parsed;
  // flat view for ctypes
  int64_t n_records;
  int64_t n_fields;
  const char* arena;
  int64_t arena_len;
  const int64_t* rec_start;
  const int64_t* key_off;
  const int64_t* key_len;
  const int64_t* val_off;
  const int64_t* val_len;
  const int8_t* kind;
  const char* error;  // non-null => failed load (handle still must be freed)
};

DllmJsonl* dllm_jsonl_parse(const char* data, int64_t size) {
  auto* h = new DllmJsonl();
  auto* out = new Parsed();
  h->parsed = out;
  // reserve using a cheap heuristic to avoid repeated arena reallocation
  out->arena.reserve(static_cast<size_t>(size));

  Cursor c{data, data + size, 1};
  while (c.p < c.end) {
    skip_ws(c);
    if (c.p < c.end && *c.p == '\n') {  // blank line
      c.p++;
      c.line++;
      continue;
    }
    if (c.p >= c.end) break;
    out->rec_start.push_back(static_cast<int64_t>(out->key_off.size()));
    if (!parse_object(c, *out)) break;
    skip_ws(c);
    if (c.p < c.end) {
      if (*c.p != '\n') {
        fail(*out, c, "trailing characters after record");
        break;
      }
      c.p++;
      c.line++;
    }
  }

  if (!out->error.empty()) {
    h->error = out->error.c_str();
    h->n_records = 0;
    return h;
  }
  out->rec_start.push_back(static_cast<int64_t>(out->key_off.size()));
  h->error = nullptr;
  h->n_records = static_cast<int64_t>(out->rec_start.size()) - 1;
  h->n_fields = static_cast<int64_t>(out->key_off.size());
  h->arena = out->arena.data();
  h->arena_len = static_cast<int64_t>(out->arena.size());
  h->rec_start = out->rec_start.data();
  h->key_off = out->key_off.data();
  h->key_len = out->key_len.data();
  h->val_off = out->val_off.data();
  h->val_len = out->val_len.data();
  h->kind = out->kind.data();
  return h;
}

DllmJsonl* dllm_jsonl_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    auto* h = new DllmJsonl();
    auto* out = new Parsed();
    out->error = std::string("cannot open ") + path;
    h->parsed = out;
    h->error = out->error.c_str();
    h->n_records = 0;
    return h;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  size_t got = fread(buf.data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  return dllm_jsonl_parse(buf.data(), static_cast<int64_t>(got));
}

void dllm_jsonl_free(DllmJsonl* h) {
  if (!h) return;
  delete h->parsed;
  delete h;
}

}  // extern "C"
