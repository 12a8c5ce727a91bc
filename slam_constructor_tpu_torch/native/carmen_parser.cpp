// Native CARMEN log parser: the host-side reader of FLASER, ROBOTLASER1 and
// ODOM-bearing records (port of the JAX package's native/carmen_parser.cpp,
// kept as the port's own copy).
//
// CARMEN is the format the MIT Stata and CSAIL 2D-lidar logs ship in.
// Parsing a log of hundreds of MB line by line in Python takes minutes;
// this parser streams the laser records into flat arrays in one pass and
// keeps the rare PARAM and TRUEPOS lines as raw text for the Python side.
// Loaded with ctypes by slam_constructor_tpu_torch/utils/dataset.py, which
// builds it with g++ into build/native/ at first use:
//
//   g++ -O2 -shared -fPIC -o libslamio.so carmen_parser.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParsedLog {
  int n_scans = 0;
  int n_beams = 0;       // beams per scan (first scan wins; others must match)
  std::vector<float> ranges;   // n_scans * n_beams
  std::vector<double> odom;    // n_scans * 3 (x, y, theta at scan time)
  std::vector<double> stamps;  // n_scans
  std::vector<double> meta;    // start_angle, fov, max_range (ROBOTLASER1)
  std::string aux;             // raw PARAM/TRUEPOS lines (rare; parsed in py)
};

// tokenize a line in place; returns token count
int split(char* line, std::vector<char*>& toks) {
  toks.clear();
  for (char* p = strtok(line, " \t\r\n"); p; p = strtok(nullptr, " \t\r\n"))
    toks.push_back(p);
  return (int)toks.size();
}

bool parse_flaser(std::vector<char*>& t, ParsedLog& out) {
  // FLASER n r0..rn-1 x y theta odom_x odom_y odom_theta ts host lts
  if (t.size() < 2) return false;
  int n = atoi(t[1]);
  if (n <= 0 || (int)t.size() < 2 + n + 6) return false;
  if (out.n_beams == 0) out.n_beams = n;
  if (n != out.n_beams) return false;  // skip inconsistent scans
  for (int i = 0; i < n; ++i) out.ranges.push_back((float)atof(t[2 + i]));
  // use the odometry pose (odom_x..), falling back to laser pose
  int base = 2 + n;
  out.odom.push_back(atof(t[base + 3]));
  out.odom.push_back(atof(t[base + 4]));
  out.odom.push_back(atof(t[base + 5]));
  double ts = ((int)t.size() > base + 6) ? atof(t[base + 6]) : out.n_scans;
  out.stamps.push_back(ts);
  out.n_scans++;
  return true;
}

bool parse_robotlaser(std::vector<char*>& t, ParsedLog& out) {
  // ROBOTLASER1 type start_angle fov res max_range accuracy remission
  //   n r0..rn-1 n_rem [rem...] lx ly lth rx ry rth tv rv fwd side turn ts..
  if (t.size() < 9) return false;
  int n = atoi(t[8]);
  if (n <= 0 || (int)t.size() < 9 + n + 1) return false;
  if (out.n_beams == 0) {
    out.n_beams = n;
    out.meta = {atof(t[2]), atof(t[3]), atof(t[5])};
  }
  if (n != out.n_beams) return false;
  for (int i = 0; i < n; ++i) out.ranges.push_back((float)atof(t[9 + i]));
  int nrem = atoi(t[9 + n]);
  int base = 9 + n + 1 + nrem;
  if ((int)t.size() < base + 6) {  // need robot pose
    out.ranges.resize(out.ranges.size() - n);
    return false;
  }
  out.odom.push_back(atof(t[base + 3]));
  out.odom.push_back(atof(t[base + 4]));
  out.odom.push_back(atof(t[base + 5]));
  double ts = ((int)t.size() > base + 11) ? atof(t[base + 11]) : out.n_scans;
  out.stamps.push_back(ts);
  out.n_scans++;
  return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle (or nullptr). Query with the getters; free with
// slamio_free.
void* slamio_parse_carmen(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* out = new ParsedLog();
  std::vector<char*> toks;
  std::string buf;
  char line[1 << 16];
  while (fgets(line, sizeof line, f)) {
    if (!strncmp(line, "FLASER", 6)) {
      split(line, toks);
      parse_flaser(toks, *out);
    } else if (!strncmp(line, "ROBOTLASER1", 11)) {
      split(line, toks);
      parse_robotlaser(toks, *out);
    } else if (!strncmp(line, "PARAM", 5) || !strncmp(line, "TRUEPOS", 7)) {
      // keep the raw line for the Python side (PARAM laser geometry,
      // TRUEPOS ground truth), still one pass over the file
      out->aux.append(line);
    }
  }
  fclose(f);
  return out;
}

int slamio_n_scans(void* h) { return ((ParsedLog*)h)->n_scans; }
int slamio_n_beams(void* h) { return ((ParsedLog*)h)->n_beams; }
const float* slamio_ranges(void* h) { return ((ParsedLog*)h)->ranges.data(); }
const double* slamio_odom(void* h) { return ((ParsedLog*)h)->odom.data(); }
const double* slamio_stamps(void* h) { return ((ParsedLog*)h)->stamps.data(); }
int slamio_meta(void* h, double* out3) {
  auto& m = ((ParsedLog*)h)->meta;
  if (m.size() < 3) return 0;
  out3[0] = m[0]; out3[1] = m[1]; out3[2] = m[2];
  return 1;
}
const char* slamio_aux(void* h) { return ((ParsedLog*)h)->aux.c_str(); }
void slamio_free(void* h) { delete (ParsedLog*)h; }

}  // extern "C"
