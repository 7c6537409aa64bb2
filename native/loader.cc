// Native event loader: CSV -> packed arrays + union-find components.
//
// Native replacement for the reference's pandas ingest path
// (helper.py:524-581, construct_graph at helper.py:465-520,
// nx.weakly_connected_components at event_conversion.py:84): one pass of
// hand-rolled CSV parsing into struct-of-arrays buffers, pair dedup with
// first-occurrence order (NetworkX re-add semantics), union-find CCA with
// min-node labels, and a CSR node->hits truth dissociation.  Exposed as a
// C ABI consumed from Python via ctypes (data/native_loader.py).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Event {
  // nodes (dense order = filtered file order)
  std::vector<double> xyzr;       // n*4
  std::vector<int32_t> vivl;      // n*2
  std::vector<int64_t> node_ids;  // original node_idx
  // deduped undirected pairs, dense ids, file order
  std::vector<int32_t> pairs;     // m*2
  // components (min dense node id per component)
  std::vector<int32_t> comp;
  // truth: per-node first-unique particle id + CSR of (hit_id, particle_id)
  std::vector<int64_t> truth_pid;     // n
  std::vector<int64_t> hit_offsets;   // n+1
  std::vector<int64_t> hit_ids;
  std::vector<int64_t> hit_pids;
  std::vector<int64_t> mod_offsets;   // n+1
  std::vector<int64_t> mod_ids;
  std::string error;
};

// Read a whole file into a string.
bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = std::fread(out->data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

struct Cursor {
  const char* p;
  const char* end;
  bool done() const { return p >= end; }
  // Advance past the current line.
  void skip_line() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  double field_double() {
    char* next = nullptr;
    double v = std::strtod(p, &next);
    p = next;
    if (p < end && (*p == ',' || *p == '\n' || *p == '\r')) {
      if (*p == '\r') ++p;
      ++p;
    }
    return v;
  }
  int64_t field_int() {
    char* next = nullptr;
    long long v = std::strtoll(p, &next, 10);
    p = next;
    if (p < end && (*p == ',' || *p == '\n' || *p == '\r')) {
      if (*p == '\r') ++p;
      ++p;
    }
    return v;
  }
};

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(int32_t n) : parent(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t i) {
    int32_t root = i;
    while (parent[root] != root) root = parent[root];
    while (parent[i] != root) {
      int32_t next = parent[i];
      parent[i] = root;
      i = next;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) return;
    if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
  }
};

}  // namespace

extern "C" {

void* gnn_load_event(const char* nodes_csv, const char* edges_csv,
                     const char* truth_csv, int min_volume, int max_volume) {
  auto* ev = new Event();
  std::string buf;

  // ---- nodes: node_idx,layer_id,x,y,z ----
  if (!read_file(nodes_csv, &buf)) {
    ev->error = "cannot read nodes csv";
    return ev;
  }
  std::unordered_map<int64_t, int32_t> remap;
  {
    Cursor c{buf.data(), buf.data() + buf.size()};
    c.skip_line();  // header
    int64_t lo = static_cast<int64_t>(min_volume) * 1000;
    int64_t hi = static_cast<int64_t>(max_volume + 1) * 1000;
    while (!c.done()) {
      int64_t node_idx = c.field_int();
      int64_t layer_id = c.field_int();
      double x = c.field_double();
      double y = c.field_double();
      double z = c.field_double();
      if (layer_id < lo || layer_id > hi) continue;
      int32_t dense = static_cast<int32_t>(ev->node_ids.size());
      remap.emplace(node_idx, dense);
      ev->node_ids.push_back(node_idx);
      double r = std::sqrt(x * x + y * y);
      ev->xyzr.insert(ev->xyzr.end(), {x, y, z, r});
      ev->vivl.push_back(static_cast<int32_t>(layer_id / 1000));
      ev->vivl.push_back(static_cast<int32_t>(layer_id % 100));
    }
  }
  const int64_t n = static_cast<int64_t>(ev->node_ids.size());

  // ---- edges: count-header line, then node2,node1,weight ----
  if (!read_file(edges_csv, &buf)) {
    ev->error = "cannot read edges csv";
    return ev;
  }
  {
    Cursor c{buf.data(), buf.data() + buf.size()};
    c.skip_line();  // "<nodes> <edges>" count header (helper.py:536-543)
    c.skip_line();  // real header
    std::unordered_map<int64_t, int32_t> seen;  // a*n+b -> 1
    UnionFind uf(static_cast<int32_t>(n));
    while (!c.done()) {
      int64_t n2 = c.field_int();
      int64_t n1 = c.field_int();
      c.field_double();  // weight (unused, as in the reference)
      auto it1 = remap.find(n1);
      auto it2 = remap.find(n2);
      if (it1 == remap.end() || it2 == remap.end()) continue;
      int32_t a = it1->second, b = it2->second;
      if (a == b) continue;
      int64_t key = (a < b)
          ? static_cast<int64_t>(a) * n + b
          : static_cast<int64_t>(b) * n + a;
      if (!seen.emplace(key, 1).second) continue;
      ev->pairs.push_back(a);
      ev->pairs.push_back(b);
      uf.unite(a, b);
    }
    ev->comp.resize(n);
    for (int32_t i = 0; i < n; ++i) ev->comp[i] = uf.find(i);
  }

  // ---- truth: node_idx,hit_id,particle_id,volume_id,layer_id,module_id,nhits
  if (!read_file(truth_csv, &buf)) {
    ev->error = "cannot read truth csv";
    return ev;
  }
  {
    // two-pass CSR: rows are grouped by file order per node (not sorted)
    struct Row { int32_t node; int64_t hit, pid, mod; };
    std::vector<Row> rows;
    Cursor c{buf.data(), buf.data() + buf.size()};
    c.skip_line();
    while (!c.done()) {
      int64_t node_idx = c.field_int();
      int64_t hit_id = c.field_int();
      int64_t pid = c.field_int();
      c.field_int();  // volume_id
      c.field_int();  // layer_id
      int64_t mod = c.field_int();
      c.field_double();  // nhits
      auto it = remap.find(node_idx);
      if (it == remap.end()) continue;
      rows.push_back({it->second, hit_id, pid, mod});
    }
    std::vector<int64_t> counts(n + 1, 0);
    for (const auto& r : rows) counts[r.node + 1]++;
    for (int64_t i = 0; i < n; ++i) counts[i + 1] += counts[i];
    ev->hit_offsets = counts;
    ev->mod_offsets.assign(n + 1, 0);
    ev->hit_ids.resize(rows.size());
    ev->hit_pids.resize(rows.size());
    std::vector<int64_t> fill(ev->hit_offsets.begin(),
                              ev->hit_offsets.end() - 1);
    for (const auto& r : rows) {
      int64_t pos = fill[r.node]++;
      ev->hit_ids[pos] = r.hit;
      ev->hit_pids[pos] = r.pid;
    }
    // first-unique particle id per node (helper.py:470-472) + unique modules
    ev->truth_pid.assign(n, -1);
    ev->mod_ids.clear();
    for (int64_t i = 0; i < n; ++i) {
      ev->mod_offsets[i] = static_cast<int64_t>(ev->mod_ids.size());
      if (ev->hit_offsets[i] < ev->hit_offsets[i + 1]) {
        ev->truth_pid[i] = ev->hit_pids[ev->hit_offsets[i]];
      }
    }
    // unique module ids per node in file order (second sweep over rows)
    std::vector<std::vector<int64_t>> mods(n);
    for (const auto& r : rows) {
      auto& v = mods[r.node];
      bool dup = false;
      for (int64_t m : v) if (m == r.mod) { dup = true; break; }
      if (!dup) v.push_back(r.mod);
    }
    ev->mod_ids.clear();
    for (int64_t i = 0; i < n; ++i) {
      ev->mod_offsets[i] = static_cast<int64_t>(ev->mod_ids.size());
      for (int64_t m : mods[i]) ev->mod_ids.push_back(m);
    }
    ev->mod_offsets[n] = static_cast<int64_t>(ev->mod_ids.size());
  }
  return ev;
}

const char* gnn_error(void* h) {
  auto* ev = static_cast<Event*>(h);
  return ev->error.empty() ? nullptr : ev->error.c_str();
}

int64_t gnn_num_nodes(void* h) {
  return static_cast<int64_t>(static_cast<Event*>(h)->node_ids.size());
}
int64_t gnn_num_pairs(void* h) {
  return static_cast<int64_t>(static_cast<Event*>(h)->pairs.size() / 2);
}
int64_t gnn_num_hits(void* h) {
  return static_cast<int64_t>(static_cast<Event*>(h)->hit_ids.size());
}
int64_t gnn_num_modules(void* h) {
  return static_cast<int64_t>(static_cast<Event*>(h)->mod_ids.size());
}

void gnn_get_nodes(void* h, double* xyzr, int32_t* vivl, int64_t* node_ids,
                   int32_t* comp, int64_t* truth_pid) {
  auto* ev = static_cast<Event*>(h);
  std::memcpy(xyzr, ev->xyzr.data(), ev->xyzr.size() * sizeof(double));
  std::memcpy(vivl, ev->vivl.data(), ev->vivl.size() * sizeof(int32_t));
  std::memcpy(node_ids, ev->node_ids.data(),
              ev->node_ids.size() * sizeof(int64_t));
  std::memcpy(comp, ev->comp.data(), ev->comp.size() * sizeof(int32_t));
  std::memcpy(truth_pid, ev->truth_pid.data(),
              ev->truth_pid.size() * sizeof(int64_t));
}

void gnn_get_pairs(void* h, int32_t* pairs) {
  auto* ev = static_cast<Event*>(h);
  std::memcpy(pairs, ev->pairs.data(), ev->pairs.size() * sizeof(int32_t));
}

void gnn_get_truth(void* h, int64_t* hit_offsets, int64_t* hit_ids,
                   int64_t* hit_pids, int64_t* mod_offsets, int64_t* mod_ids) {
  auto* ev = static_cast<Event*>(h);
  std::memcpy(hit_offsets, ev->hit_offsets.data(),
              ev->hit_offsets.size() * sizeof(int64_t));
  std::memcpy(hit_ids, ev->hit_ids.data(),
              ev->hit_ids.size() * sizeof(int64_t));
  std::memcpy(hit_pids, ev->hit_pids.data(),
              ev->hit_pids.size() * sizeof(int64_t));
  std::memcpy(mod_offsets, ev->mod_offsets.data(),
              ev->mod_offsets.size() * sizeof(int64_t));
  std::memcpy(mod_ids, ev->mod_ids.data(),
              ev->mod_ids.size() * sizeof(int64_t));
}

void gnn_free(void* h) { delete static_cast<Event*>(h); }

// Standalone union-find CCA over a masked directed edge list: label = min
// node id of the weak component.  Used as the host-side fast path for the
// per-iteration extraction CCA (the device label-propagation path needs
// ~50 rounds of edge-sized ops; this is one linear pass).
void gnn_cca(int64_t n, int64_t e, const int32_t* src, const int32_t* dst,
             const uint8_t* ok, int32_t* labels) {
  UnionFind uf(static_cast<int32_t>(n));
  for (int64_t i = 0; i < e; ++i) {
    if (ok[i]) uf.unite(src[i], dst[i]);
  }
  for (int64_t i = 0; i < n; ++i) {
    labels[i] = uf.find(static_cast<int32_t>(i));
  }
}

}  // extern "C"
