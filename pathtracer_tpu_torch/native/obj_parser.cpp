// Native Wavefront OBJ parser (geometry tier).
//
// C++ implementation of the line parse in models/obj.py (same contract:
// v/vn/f/usemtl, negative-index resolution, n-gon fan split, faces grouped
// by the active usemtl name). The reference parses OBJ text in interpreted
// TypeScript on the hot startup path (src/ts-util/parse-obj.ts); this
// native version keeps multi-million-line meshes interactive. MTL material
// parsing stays in Python (tiny files, rich dict handling).
//
// Opaque-handle C ABI for ctypes: parse -> query sizes -> fill -> free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<double> positions;   // 3 per vertex
  std::vector<double> normals;     // 3 per normal
  std::vector<int32_t> faces;      // 3 per tri
  std::vector<int32_t> face_norm;  // 3 per tri (-1 = none)
  std::vector<int32_t> face_group; // 1 per tri
  std::string group_names;         // '\n'-separated, in first-use order
  int n_groups = 0;
};

// Skip spaces/tabs.
static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char* line_end(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p;
}

static inline double parse_double(const char*& p, const char* end) {
  char* out = nullptr;
  double v = std::strtod(p, &out);
  p = out ? out : p;
  (void)end;
  return v;
}

static inline long parse_long(const char*& p) {
  char* out = nullptr;
  long v = std::strtol(p, &out, 10);
  p = out ? out : p;
  return v;
}

}  // namespace

extern "C" {

void* pt_obj_parse(const char* text, long len) {
  ObjData* d = new ObjData();
  d->positions.reserve(1 << 12);
  d->faces.reserve(1 << 12);

  const char* p = text;
  const char* end = text + len;
  int cur_group = 0;
  d->group_names = "default";
  d->n_groups = 1;
  std::vector<long> vi, ni;  // per-face scratch

  while (p < end) {
    p = skip_ws(p, end);
    const char* eol = line_end(p, end);
    if (p >= eol) {
      p = eol + 1;
      continue;
    }
    if (p[0] == 'v' && p + 1 < eol && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      double x = parse_double(q, eol);
      double y = parse_double(q, eol);
      double z = parse_double(q, eol);
      d->positions.push_back(x);
      d->positions.push_back(y);
      d->positions.push_back(z);
    } else if (p[0] == 'v' && p + 2 < eol && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      const char* q = p + 3;
      double x = parse_double(q, eol);
      double y = parse_double(q, eol);
      double z = parse_double(q, eol);
      d->normals.push_back(x);
      d->normals.push_back(y);
      d->normals.push_back(z);
    } else if (p[0] == 'f' && p + 1 < eol && (p[1] == ' ' || p[1] == '\t')) {
      vi.clear();
      ni.clear();
      const char* q = p + 1;
      long nv = (long)(d->positions.size() / 3);
      long nn = (long)(d->normals.size() / 3);
      while (true) {
        q = skip_ws(q, eol);
        if (q >= eol || *q == '#') break;
        long v = parse_long(q);
        long n = 0;
        bool has_n = false;
        if (q < eol && *q == '/') {
          ++q;  // texcoord slot
          while (q < eol && *q != '/' && *q != ' ' && *q != '\t') ++q;
          if (q < eol && *q == '/') {
            ++q;
            if (q < eol && *q != ' ' && *q != '\t') {
              n = parse_long(q);
              has_n = true;
            }
          }
        }
        vi.push_back(v > 0 ? v - 1 : nv + v);
        ni.push_back(has_n ? (n > 0 ? n - 1 : nn + n) : -1);
      }
      for (size_t k = 1; k + 1 < vi.size(); ++k) {  // fan split
        d->faces.push_back((int32_t)vi[0]);
        d->faces.push_back((int32_t)vi[k]);
        d->faces.push_back((int32_t)vi[k + 1]);
        d->face_norm.push_back((int32_t)ni[0]);
        d->face_norm.push_back((int32_t)ni[k]);
        d->face_norm.push_back((int32_t)ni[k + 1]);
        d->face_group.push_back(cur_group);
      }
    } else if (eol - p > 7 && std::memcmp(p, "usemtl", 6) == 0 &&
               (p[6] == ' ' || p[6] == '\t')) {
      const char* q = skip_ws(p + 6, eol);
      const char* name_end = q;
      while (name_end < eol && *name_end != ' ' && *name_end != '\t' &&
             *name_end != '\r' && *name_end != '#')
        ++name_end;
      std::string name(q, name_end);
      // Find existing group or append.
      int gid = -1, idx = 0;
      size_t pos = 0;
      while (pos <= d->group_names.size()) {
        size_t nl = d->group_names.find('\n', pos);
        std::string g = d->group_names.substr(
            pos, (nl == std::string::npos ? d->group_names.size() : nl) - pos);
        if (g == name) {
          gid = idx;
          break;
        }
        if (nl == std::string::npos) break;
        pos = nl + 1;
        ++idx;
      }
      if (gid < 0) {
        d->group_names += "\n" + name;
        gid = d->n_groups++;
      }
      cur_group = gid;
    }
    p = eol + 1;
  }
  return d;
}

void pt_obj_sizes(void* h, int64_t* nv, int64_t* nvn, int64_t* ntri,
                  int64_t* names_len) {
  ObjData* d = (ObjData*)h;
  *nv = (int64_t)(d->positions.size() / 3);
  *nvn = (int64_t)(d->normals.size() / 3);
  *ntri = (int64_t)(d->faces.size() / 3);
  *names_len = (int64_t)d->group_names.size();
}

void pt_obj_fill(void* h, double* pos, double* nrm, int32_t* faces,
                 int32_t* fn, int32_t* fg, char* names) {
  ObjData* d = (ObjData*)h;
  std::memcpy(pos, d->positions.data(), d->positions.size() * sizeof(double));
  std::memcpy(nrm, d->normals.data(), d->normals.size() * sizeof(double));
  std::memcpy(faces, d->faces.data(), d->faces.size() * sizeof(int32_t));
  std::memcpy(fn, d->face_norm.data(), d->face_norm.size() * sizeof(int32_t));
  std::memcpy(fg, d->face_group.data(), d->face_group.size() * sizeof(int32_t));
  std::memcpy(names, d->group_names.data(), d->group_names.size());
}

void pt_obj_free(void* h) { delete (ObjData*)h; }

}  // extern "C"
