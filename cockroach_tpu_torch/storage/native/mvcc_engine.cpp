// mvcc_engine.cpp — native MVCC storage engine (the Pebble-class C++
// component, SURVEY.md §2.8: "C++ equivalent required ... purpose-built C++
// LSM with MVCC-aware iterators + Arrow-emitting scanner").
//
// Semantics mirrored from the reference (behavior, not code):
//   - MVCCKey = (user key bytes, HLC timestamp (wall, logical));
//     versions of one key sort newest-first (pkg/storage/mvcc_key.go:39).
//   - Readers at read-ts observe the newest version with ts <= read-ts;
//     an empty value is a tombstone hiding older versions
//     (pkg/storage/mvcc.go:1397 MVCCGet, :5030 MVCCScan).
//   - scan_to_cols decodes visible row payloads straight into COLUMN-MAJOR
//     int64 buffers — the MVCCScanToCols analog (pkg/storage/col_mvcc.go:391)
//     whose whole point is that the scan emits device-ingestible columns,
//     not row tuples (diagram col_mvcc.go:25-67).
//
// Shape: a mini-LSM — one sorted in-memory memtable + immutable sorted
// runs, merged on read through a k-way heap iterator; flush on threshold,
// full merge-compaction when runs pile up (Pebble's role in the reference;
// go.mod:142). Single-writer / external synchronization expected (Python
// callers hold the GIL across calls).
//
// ABI: plain C functions over an opaque handle, ctypes-friendly: no C++
// types cross the boundary, all buffers caller-allocated.

// Durability (round 4, VERDICT #8): an engine opened AT A DIRECTORY
// (eng_open_at) persists every put to a write-ahead log and every flushed
// run to an on-disk sorted-run file ("SST"), tracked by an atomically
// rewritten MANIFEST; eng_open_at replays MANIFEST runs + the WAL tail,
// so kill -9 + reopen recovers all synced writes (the Pebble WAL/SST/
// MANIFEST role, pkg/storage/pebble.go:886 — role, not design). Sync
// granularity: the WAL is fsync'd on eng_sync()/flush/close, not per
// put (callers needing commit durability call eng_sync at their commit
// points; the replication layer's quorum provides the primary
// durability story, as in the reference).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <queue>
#include <string>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct Ts {
  uint64_t wall = 0;
  uint32_t logical = 0;
  bool le(const Ts& o) const {
    return wall < o.wall || (wall == o.wall && logical <= o.logical);
  }
  bool eq(const Ts& o) const { return wall == o.wall && logical == o.logical; }
};

// Versioned key: user key ascending, timestamp DESCENDING (newest first) —
// the reference's MVCC key ordering (mvcc_key.go:39).
struct VKey {
  std::string key;
  Ts ts;
  bool operator<(const VKey& o) const {
    int c = key.compare(o.key);
    if (c != 0) return c < 0;
    if (ts.wall != o.ts.wall) return ts.wall > o.ts.wall;   // desc
    return ts.logical > o.ts.logical;                        // desc
  }
};

struct Entry {
  VKey vk;
  std::string value;  // empty => tombstone
};

using Run = std::vector<Entry>;  // sorted by VKey

// ---- on-disk formats ------------------------------------------------------
// WAL / run record:
//   u32 crc32c | u32 klen | u32 vlen | u64 wall | u32 logical | key | value
// where crc32c (Castagnoli, poly 0x82F63B78 — the reference's WAL/SST
// checksum family) covers everything AFTER the crc field. A record whose
// crc fails, whose header is implausible, or whose body is short is a
// TORN TAIL: replay stops at the last good record and truncates the file
// there (never a fatal parse error, never silent acceptance of garbage).
// Run file:    u64 count, then `count` records in VKey order
// MANIFEST:    text: first line = next_run_seq, then one run file name per
//              line, NEWEST FIRST; rewritten via tmp+rename (atomic)
// The export/ingest SPAN exchange format (eng_export_span) stays the
// crc-less 20-byte-header layout: it is an in-memory ABI between live
// processes, not a durable surface.

uint32_t g_crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      g_crc_table[i] = c;
    }
  }
} g_crc_init;

// Raw (pre-inverted) running state: seed with 0xFFFFFFFF, finalize with ~.
uint32_t crc32c_update(uint32_t state, const void* data, size_t n) {
  const uint8_t* p = (const uint8_t*)data;
  while (n--) state = g_crc_table[(state ^ *p++) & 0xFF] ^ (state >> 8);
  return state;
}

uint32_t record_crc(uint32_t klen, uint32_t vlen, uint64_t wall,
                    uint32_t logical, const char* key, const char* val) {
  uint8_t hdr[20];
  std::memcpy(hdr, &klen, 4);
  std::memcpy(hdr + 4, &vlen, 4);
  std::memcpy(hdr + 8, &wall, 8);
  std::memcpy(hdr + 16, &logical, 4);
  uint32_t s = 0xFFFFFFFFu;
  s = crc32c_update(s, hdr, 20);
  s = crc32c_update(s, key, klen);
  s = crc32c_update(s, val, vlen);
  return ~s;
}

bool write_all(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool append_record(FILE* f, const VKey& vk, const std::string& val) {
  uint32_t klen = (uint32_t)vk.key.size(), vlen = (uint32_t)val.size();
  uint32_t crc = record_crc(klen, vlen, vk.ts.wall, vk.ts.logical,
                            vk.key.data(), val.data());
  return write_all(f, &crc, 4) && write_all(f, &klen, 4) &&
         write_all(f, &vlen, 4) && write_all(f, &vk.ts.wall, 8) &&
         write_all(f, &vk.ts.logical, 4) &&
         write_all(f, vk.key.data(), klen) && write_all(f, val.data(), vlen);
}

// false => EOF or torn/corrupt record (the caller treats the file as
// ending at the last good record; *crc_bad distinguishes a checksum
// mismatch from a plain short tail, for recovery stats).
bool read_record(FILE* f, VKey* vk, std::string* val, bool* crc_bad = nullptr) {
  if (crc_bad) *crc_bad = false;
  uint32_t crc, klen, vlen;
  if (fread(&crc, 1, 4, f) != 4 || fread(&klen, 1, 4, f) != 4 ||
      fread(&vlen, 1, 4, f) != 4)
    return false;
  if (klen > (1u << 20) || vlen > (1u << 28)) return false;  // corrupt tail
  uint64_t wall;
  uint32_t logical;
  if (fread(&wall, 1, 8, f) != 8 || fread(&logical, 1, 4, f) != 4)
    return false;
  vk->key.resize(klen);
  val->resize(vlen);
  if (klen && fread(&vk->key[0], 1, klen, f) != klen) return false;
  if (vlen && fread(&(*val)[0], 1, vlen, f) != vlen) return false;
  if (record_crc(klen, vlen, wall, logical, vk->key.data(), val->data()) !=
      crc) {
    if (crc_bad) *crc_bad = true;
    return false;
  }
  vk->ts = Ts{wall, logical};
  return true;
}

void fsync_file(FILE* f) {
  if (f) {
    fflush(f);
    fsync(fileno(f));
  }
}

struct Engine {
  std::map<VKey, std::string> mem;
  size_t mem_bytes = 0;
  std::vector<std::shared_ptr<Run>> runs;  // newest first
  size_t flush_threshold = 16 << 20;       // 16 MiB memtable
  size_t max_runs = 8;
  uint64_t n_puts = 0;

  // durability state (empty dir => ephemeral in-memory engine)
  std::string dir;
  FILE* wal = nullptr;
  uint64_t next_run_seq = 1;
  std::vector<std::string> run_files;  // parallel to `runs` (newest first)

  // recovery forensics from the last open_at (eng_stats 4/5/6)
  uint64_t wal_replayed = 0;     // records recovered from the WAL tail
  uint64_t torn_bytes = 0;       // torn-tail bytes truncated at replay
  uint64_t crc_failures = 0;     // records rejected by checksum

  bool durable() const { return !dir.empty(); }
  std::string path(const std::string& name) const { return dir + "/" + name; }

  ~Engine() {
    if (wal) {
      fsync_file(wal);
      fclose(wal);
    }
  }

  bool write_run_file(const std::string& name, const Run& run) {
    std::string tmp = path(name) + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return false;
    uint64_t count = run.size();
    bool ok = write_all(f, &count, 8);
    for (auto& e : run)
      if (ok) ok = append_record(f, e.vk, e.value);
    fsync_file(f);
    fclose(f);
    if (!ok) return false;
    return rename(tmp.c_str(), path(name).c_str()) == 0;
  }

  bool read_run_file(const std::string& name, Run* run) {
    FILE* f = fopen(path(name).c_str(), "rb");
    if (!f) return false;
    uint64_t count = 0;
    if (fread(&count, 1, 8, f) != 8) {
      fclose(f);
      return false;
    }
    run->reserve(count);
    VKey vk;
    std::string val;
    bool crc_bad = false;
    for (uint64_t i = 0; i < count; i++) {
      if (!read_record(f, &vk, &val, &crc_bad)) {
        // run files are written whole via tmp+rename, so a bad record
        // means bit-rot: keep the verified prefix, count the damage
        if (crc_bad) crc_failures++;
        break;
      }
      run->push_back({vk, val});
    }
    fclose(f);
    return true;
  }

  void persist_manifest() {
    std::string tmp = path("MANIFEST.tmp");
    FILE* f = fopen(tmp.c_str(), "w");
    if (!f) return;
    fprintf(f, "%llu\n", (unsigned long long)next_run_seq);
    for (auto& n : run_files) fprintf(f, "%s\n", n.c_str());
    fsync_file(f);
    fclose(f);
    rename(tmp.c_str(), path("MANIFEST").c_str());
  }

  void wal_reset() {
    if (!wal) return;
    fclose(wal);
    wal = fopen(path("wal.log").c_str(), "wb");  // truncate
    fsync_file(wal);
  }

  void flush() {
    if (mem.empty()) return;
    auto run = std::make_shared<Run>();
    run->reserve(mem.size());
    for (auto& kv : mem) run->push_back({kv.first, kv.second});
    if (durable()) {
      std::string name = "run_" + std::to_string(next_run_seq++) + ".sst";
      if (write_run_file(name, *run)) {
        run_files.insert(run_files.begin(), name);
        persist_manifest();
        // run + manifest durable => the WAL's copies are redundant; a
        // crash between write_run_file and wal_reset just replays
        // entries the run already holds (identical versions shadow)
        wal_reset();
      }
    }
    runs.insert(runs.begin(), run);
    mem.clear();
    mem_bytes = 0;
    if (runs.size() > max_runs) compact();
  }

  void add_ingested_run(std::shared_ptr<Run> run) {
    // bulk ingest (the AddSSTable analog, batcheval/cmd_add_sstable.go):
    // the run becomes durable directly as a run file — no WAL traffic
    if (durable()) {
      std::string name = "run_" + std::to_string(next_run_seq++) + ".sst";
      if (write_run_file(name, *run)) {
        run_files.insert(run_files.begin(), name);
        persist_manifest();
      }
    }
    runs.insert(runs.begin(), run);
    if (runs.size() > max_runs) compact();
  }

  // Full merge of all runs into one (keeps every version: GC is a separate
  // operation, as in the reference where MVCC GC is a queue-driven command).
  void compact() {
    auto merged = std::make_shared<Run>();
    size_t total = 0;
    for (auto& r : runs) total += r->size();
    merged->reserve(total);
    // k-way merge via repeated min pick (runs are sorted); use a heap of
    // (entry, run index, pos)
    struct HeapItem {
      const Entry* e;
      size_t run, pos;
    };
    auto cmp = [](const HeapItem& a, const HeapItem& b) {
      // min-heap on VKey; ties (same VKey in two runs) keep the NEWER run
      // (lower run index) first so it wins below
      if (b.e->vk < a.e->vk) return true;
      if (a.e->vk < b.e->vk) return false;
      return a.run > b.run;
    };
    std::priority_queue<HeapItem, std::vector<HeapItem>, decltype(cmp)> heap(cmp);
    for (size_t i = 0; i < runs.size(); i++)
      if (!runs[i]->empty()) heap.push({&(*runs[i])[0], i, 0});
    const VKey* last = nullptr;
    while (!heap.empty()) {
      HeapItem h = heap.top();
      heap.pop();
      // identical (key, ts) across runs: newest run's value wins, drop dups
      if (last == nullptr || *last < h.e->vk || h.e->vk < *last) {
        merged->push_back(*h.e);
        last = &merged->back().vk;
      }
      if (h.pos + 1 < runs[h.run]->size())
        heap.push({&(*runs[h.run])[h.pos + 1], h.run, h.pos + 1});
    }
    if (durable()) {
      std::string name = "run_" + std::to_string(next_run_seq++) + ".sst";
      if (write_run_file(name, *merged)) {
        std::vector<std::string> old = run_files;
        run_files.assign(1, name);
        persist_manifest();
        for (auto& o : old) unlink(path(o).c_str());
      }
    }
    runs.clear();
    runs.push_back(merged);
  }

  void put(const VKey& vk, std::string value) {
    if (wal) append_record(wal, vk, value);
    mem_bytes += vk.key.size() + value.size() + 24;
    mem[vk] = std::move(value);
    n_puts++;
    if (mem_bytes >= flush_threshold) flush();
  }

  bool open_at(const std::string& d) {
    dir = d;
    mkdir(dir.c_str(), 0755);
    FILE* mf = fopen(path("MANIFEST").c_str(), "r");
    if (mf) {
      char line[4096];
      if (fgets(line, sizeof line, mf))
        next_run_seq = strtoull(line, nullptr, 10);
      while (fgets(line, sizeof line, mf)) {
        size_t n = strlen(line);
        while (n && (line[n - 1] == '\n' || line[n - 1] == '\r')) line[--n] = 0;
        if (!n) continue;
        auto run = std::make_shared<Run>();
        if (read_run_file(line, run.get())) {
          runs.push_back(run);  // manifest order IS newest-first
          run_files.push_back(line);
        }
      }
      fclose(mf);
    }
    // replay the WAL tail into the memtable (no re-append: wal not open).
    // A record that fails its checksum or reads short is a torn tail
    // from a mid-write crash: stop at the last GOOD record and truncate
    // the file there, so the reopened WAL appends from a verified
    // boundary instead of interleaving fresh records with garbage.
    FILE* wf = fopen(path("wal.log").c_str(), "rb");
    if (wf) {
      VKey vk;
      std::string val;
      long good_end = 0;
      bool crc_bad = false;
      while (read_record(wf, &vk, &val, &crc_bad)) {
        good_end = ftell(wf);
        mem_bytes += vk.key.size() + val.size() + 24;
        mem[vk] = val;
        wal_replayed++;
      }
      if (crc_bad) crc_failures++;
      fseek(wf, 0, SEEK_END);
      long file_end = ftell(wf);
      fclose(wf);
      if (file_end > good_end) {
        torn_bytes += (uint64_t)(file_end - good_end);
        if (truncate(path("wal.log").c_str(), good_end) != 0) return false;
      }
    }
    wal = fopen(path("wal.log").c_str(), "ab");
    return wal != nullptr;
  }
};

// ---- MVCC read path -------------------------------------------------------

// Newest version of `key` with ts <= read_ts across memtable + runs.
// Returns nullptr if none. (MVCCGet semantics, mvcc.go:1397.)
const std::string* mvcc_get(Engine* e, const std::string& key, Ts read_ts,
                            Ts* out_ts) {
  const std::string* best = nullptr;
  Ts best_ts{0, 0};
  VKey probe{key, read_ts};  // first version with ts <= read_ts in desc order

  auto consider = [&](const VKey& vk, const std::string& v) {
    if (vk.key != key) return;
    if (!vk.ts.le(read_ts)) return;
    if (best == nullptr || (best_ts.le(vk.ts) && !best_ts.eq(vk.ts))) {
      best = &v;
      best_ts = vk.ts;
    }
  };
  auto it = e->mem.lower_bound(probe);
  if (it != e->mem.end()) consider(it->first, it->second);
  for (auto& r : e->runs) {
    auto rit = std::lower_bound(
        r->begin(), r->end(), probe,
        [](const Entry& a, const VKey& b) { return a.vk < b; });
    if (rit != r->end()) consider(rit->vk, rit->value);
  }
  if (best && best->empty()) return nullptr;  // tombstone
  if (best && out_ts) *out_ts = best_ts;
  return best;
}

// Merged forward iterator over memtable + runs (all versions, VKey order).
struct MergeIter {
  struct Cursor {
    // memtable cursor
    std::map<VKey, std::string>::const_iterator mit, mend;
    // run cursor
    const Run* run = nullptr;
    size_t pos = 0;
    bool is_mem = false;
    bool valid() const {
      return is_mem ? (mit != mend) : (run && pos < run->size());
    }
    const VKey& vk() const { return is_mem ? mit->first : (*run)[pos].vk; }
    const std::string& val() const {
      return is_mem ? mit->second : (*run)[pos].value;
    }
    void next() {
      if (is_mem)
        ++mit;
      else
        ++pos;
    }
  };
  std::vector<Cursor> cursors;

  MergeIter(Engine* e, const std::string& start) {
    Cursor m;
    m.is_mem = true;
    m.mit = e->mem.lower_bound(VKey{start, Ts{UINT64_MAX, UINT32_MAX}});
    m.mend = e->mem.end();
    cursors.push_back(m);
    for (auto& r : e->runs) {
      Cursor c;
      c.run = r.get();
      c.pos = std::lower_bound(r->begin(), r->end(),
                               VKey{start, Ts{UINT64_MAX, UINT32_MAX}},
                               [](const Entry& a, const VKey& b) {
                                 return a.vk < b;
                               }) -
              r->begin();
      cursors.push_back(c);
    }
  }

  // index of cursor holding the smallest VKey (newest-run-first on ties,
  // i.e. memtable wins, then runs in recency order), or -1.
  int best() const {
    int b = -1;
    for (size_t i = 0; i < cursors.size(); i++) {
      if (!cursors[i].valid()) continue;
      if (b < 0 || cursors[i].vk() < cursors[b].vk()) b = (int)i;
    }
    return b;
  }
};

}  // namespace

extern "C" {

void* eng_open() { return new Engine(); }

// Durable engine rooted at a directory: loads MANIFEST runs, replays the
// WAL tail, reopens the WAL for append. NULL/empty path = eng_open().
void* eng_open_at(const uint8_t* dirpath, int32_t plen) {
  auto* e = new Engine();
  if (dirpath && plen > 0) {
    if (!e->open_at(std::string((const char*)dirpath, plen))) {
      delete e;
      return nullptr;
    }
  }
  return e;
}

// fsync the WAL: everything put() so far survives kill -9.
void eng_sync(void* h) { fsync_file(static_cast<Engine*>(h)->wal); }

void eng_close(void* h) { delete static_cast<Engine*>(h); }

// Bulk ingest (AddSSTable analog): n rows of a fixed-width table,
// pks ascending or not (sorted here if needed), cols column-major with
// stride n (cols[c*n + i]). Bypasses memtable AND WAL: the rows become
// one sorted run, written directly as a durable run file when the engine
// has a directory. Key layout matches storage/mvcc.py encode_key:
// u16 BE table_id | u64 BE pk.
void eng_ingest(void* h, uint32_t table_id, int64_t n, const int64_t* pks,
                int32_t ncols, const int64_t* cols, uint64_t wall,
                uint32_t logical) {
  auto* e = static_cast<Engine*>(h);
  auto run = std::make_shared<Run>();
  run->reserve(n);
  Ts ts{wall, logical};
  std::string key(10, '\0'), val(ncols * 8, '\0');
  for (int64_t i = 0; i < n; i++) {
    uint64_t pk = (uint64_t)pks[i];
    key[0] = (char)((table_id >> 8) & 0xFF);
    key[1] = (char)(table_id & 0xFF);
    for (int b = 0; b < 8; b++)
      key[2 + b] = (char)((pk >> (8 * (7 - b))) & 0xFF);
    for (int32_t c = 0; c < ncols; c++) {
      int64_t v = cols[(int64_t)c * n + i];
      std::memcpy(&val[c * 8], &v, 8);  // little-endian host assumed
    }
    run->push_back({VKey{key, ts}, val});
    e->n_puts++;
  }
  bool sorted = true;
  for (int64_t i = 1; i < n && sorted; i++)
    if (pks[i] <= pks[i - 1]) sorted = false;
  if (!sorted)
    std::sort(run->begin(), run->end(),
              [](const Entry& a, const Entry& b) { return a.vk < b.vk; });
  e->add_ingested_run(run);
}

void eng_set_flush_threshold(void* h, uint64_t bytes) {
  static_cast<Engine*>(h)->flush_threshold = bytes;
}

void eng_put(void* h, const uint8_t* key, int32_t klen, uint64_t wall,
             uint32_t logical, const uint8_t* val, int32_t vlen) {
  auto* e = static_cast<Engine*>(h);
  e->put(VKey{std::string((const char*)key, klen), Ts{wall, logical}},
         std::string((const char*)val, vlen));
}

// Returns value length (>=0) and fills out (up to cap) + version ts; -1 if
// the key has no visible version at the read timestamp.
int64_t eng_get(void* h, const uint8_t* key, int32_t klen, uint64_t wall,
                uint32_t logical, uint8_t* out, int64_t cap,
                uint64_t* ver_wall, uint32_t* ver_logical) {
  auto* e = static_cast<Engine*>(h);
  Ts vts;
  const std::string* v =
      mvcc_get(e, std::string((const char*)key, klen), Ts{wall, logical}, &vts);
  if (!v) return -1;
  int64_t n = std::min<int64_t>((int64_t)v->size(), cap);
  if (n > 0) std::memcpy(out, v->data(), n);
  if (ver_wall) *ver_wall = vts.wall;
  if (ver_logical) *ver_logical = vts.logical;
  return (int64_t)v->size();
}

// MVCC range scan [start, end) at read-ts, visiting the newest visible
// version per user key (tombstones skipped), DECODING each value as
// `ncols` little-endian int64 fields into COLUMN-MAJOR output buffers
// (out_cols laid out as ncols consecutive blocks of max_rows int64s) and
// optionally emitting the row's key hash + version wall into side arrays.
// Returns the number of rows written (<= max_rows); *more is set to 1 when
// the scan stopped early because max_rows filled (resume from *resume_key).
// This is the cFetcher-inside-the-KV-server seam (col_mvcc.go:391): the
// output buffers ARE the scan chunk the TPU ScanOp packs and ships.
// out_pks (optional, may be null): per-row primary key decoded from the
// big-endian (table u16, pk u64) key codec — emitted so batched lookup
// paths (kv/streamer.py) and pk-column reconstruction never re-walk the
// keys through a second call + Python decode.
int64_t eng_scan_to_cols(void* h, const uint8_t* start, int32_t slen,
                         const uint8_t* end, int32_t elen, uint64_t wall,
                         uint32_t logical, int32_t ncols, int64_t* out_cols,
                         int64_t max_rows, uint8_t* resume_key,
                         int32_t resume_cap, int32_t* resume_len,
                         int32_t* more, int64_t* out_pks) {
  auto* e = static_cast<Engine*>(h);
  std::string skey((const char*)start, slen), ekey((const char*)end, elen);
  Ts read_ts{wall, logical};
  MergeIter mi(e, skey);
  int64_t rows = 0;
  if (more) *more = 0;
  std::string cur_key;
  bool emitted_cur = false;
  int b;
  while ((b = mi.best()) >= 0) {
    const VKey& vk = mi.cursors[b].vk();
    if (!ekey.empty() && vk.key >= ekey) break;
    if (vk.key != cur_key) {
      cur_key = vk.key;
      emitted_cur = false;
    }
    const std::string& val = mi.cursors[b].val();
    bool visible = vk.ts.le(read_ts);
    // advance ALL cursors holding this exact (key, ts) — newest source
    // (memtable, then newer runs) wins; duplicates are shadowed history
    VKey cur_vk = vk;
    for (auto& c : mi.cursors)
      while (c.valid() && !(cur_vk < c.vk()) && !(c.vk() < cur_vk)) c.next();
    if (emitted_cur || !visible) continue;
    emitted_cur = true;  // newest visible version decides: value or skip
    if (val.empty()) continue;  // tombstone: key invisible at read_ts
    if (rows >= max_rows) {
      if (more) *more = 1;
      if (resume_key && resume_len) {
        int32_t n = std::min<int32_t>((int32_t)cur_key.size(), resume_cap);
        std::memcpy(resume_key, cur_key.data(), n);
        *resume_len = n;
      }
      return rows;
    }
    int64_t fields = std::min<int64_t>(ncols, (int64_t)(val.size() / 8));
    for (int64_t c = 0; c < fields; c++) {
      int64_t v;
      std::memcpy(&v, val.data() + c * 8, 8);
      out_cols[c * max_rows + rows] = v;
    }
    for (int64_t c = fields; c < ncols; c++) out_cols[c * max_rows + rows] = 0;
    if (out_pks) {
      uint64_t pk = 0;
      if (cur_key.size() >= 10)
        for (int i = 2; i < 10; i++)
          pk = (pk << 8) | (uint8_t)cur_key[i];
      out_pks[rows] = (int64_t)pk;
    }
    rows++;
  }
  return rows;
}

// All visible user keys in [start, end) at read-ts, concatenated into
// out_keys as length-prefixed (u16 LE) byte strings. Returns row count.
int64_t eng_scan_keys(void* h, const uint8_t* start, int32_t slen,
                      const uint8_t* end, int32_t elen, uint64_t wall,
                      uint32_t logical, uint8_t* out_keys, int64_t out_cap,
                      int64_t max_rows) {
  auto* e = static_cast<Engine*>(h);
  std::string skey((const char*)start, slen), ekey((const char*)end, elen);
  Ts read_ts{wall, logical};
  MergeIter mi(e, skey);
  int64_t rows = 0, off = 0;
  std::string cur_key;
  bool emitted_cur = false;
  int b;
  while ((b = mi.best()) >= 0 && rows < max_rows) {
    const VKey& vk = mi.cursors[b].vk();
    if (!ekey.empty() && vk.key >= ekey) break;
    if (vk.key != cur_key) {
      cur_key = vk.key;
      emitted_cur = false;
    }
    const std::string& val = mi.cursors[b].val();
    bool visible = vk.ts.le(read_ts);
    VKey cur_vk = vk;
    for (auto& c : mi.cursors)
      while (c.valid() && !(cur_vk < c.vk()) && !(c.vk() < cur_vk)) c.next();
    if (emitted_cur || !visible) continue;
    emitted_cur = true;
    if (val.empty()) continue;
    int64_t need = 2 + (int64_t)cur_key.size();
    if (off + need > out_cap) break;
    out_keys[off] = (uint8_t)(cur_key.size() & 0xFF);
    out_keys[off + 1] = (uint8_t)((cur_key.size() >> 8) & 0xFF);
    std::memcpy(out_keys + off + 2, cur_key.data(), cur_key.size());
    off += need;
    rows++;
  }
  return rows;
}

// ---- range-snapshot seam (export / clear / ingest of a keyspan) ----------
// The replication layer's engine-agnostic snapshot interface: a range
// snapshot is EVERY MVCC version (tombstones included) of every key in
// [start, end), serialized as span records (u32 klen | u32 vlen |
// u64 wall | u32 logical | key | value — no crc: this is a live in-memory
// exchange, not a durable file). The leader exports, the follower
// clears its span and ingests — the AddSSTable-shaped InstallSnapshot
// path (kvserver snapshot application ingests SSTs in the reference).

// Serialize all versions in [start, end) into `out` (whole records only,
// up to `cap` bytes). Returns the TOTAL bytes required — when the return
// exceeds cap, the caller re-calls with a buffer of that size.
// *n_records = records actually written.
int64_t eng_export_span(void* h, const uint8_t* start, int32_t slen,
                        const uint8_t* end, int32_t elen, uint8_t* out,
                        int64_t cap, int64_t* n_records) {
  auto* e = static_cast<Engine*>(h);
  std::string skey((const char*)start, slen), ekey((const char*)end, elen);
  MergeIter mi(e, skey);
  int64_t need = 0, written = 0;
  int b;
  while ((b = mi.best()) >= 0) {
    // copy: advancing the cursors below invalidates the references
    const VKey vk = mi.cursors[b].vk();
    if (!ekey.empty() && vk.key >= ekey) break;
    const std::string val = mi.cursors[b].val();
    // advance ALL cursors holding this exact (key, ts): shadowed
    // duplicates across runs must not export twice
    for (auto& c : mi.cursors)
      while (c.valid() && !(vk < c.vk()) && !(c.vk() < vk)) c.next();
    int64_t rec = 20 + (int64_t)vk.key.size() + (int64_t)val.size();
    if (out && need + rec <= cap) {
      uint8_t* p = out + need;
      uint32_t klen = (uint32_t)vk.key.size();
      uint32_t vlen = (uint32_t)val.size();
      std::memcpy(p, &klen, 4);
      std::memcpy(p + 4, &vlen, 4);
      std::memcpy(p + 8, &vk.ts.wall, 8);
      std::memcpy(p + 16, &vk.ts.logical, 4);
      std::memcpy(p + 20, vk.key.data(), klen);
      std::memcpy(p + 20 + klen, val.data(), vlen);
      written++;
    }
    need += rec;
  }
  if (n_records) *n_records = written;
  return need;
}

// Drop EVERY version of every key in [start, end) — memtable and runs.
// Durable engines rewrite their persisted state (filtered runs + a WAL
// reset) so a reopen cannot resurrect cleared keys.
void eng_clear_span(void* h, const uint8_t* start, int32_t slen,
                    const uint8_t* end, int32_t elen) {
  auto* e = static_cast<Engine*>(h);
  std::string skey((const char*)start, slen), ekey((const char*)end, elen);
  auto in_span = [&](const std::string& k) {
    return k >= skey && (ekey.empty() || k < ekey);
  };
  auto it = e->mem.lower_bound(VKey{skey, Ts{UINT64_MAX, UINT32_MAX}});
  while (it != e->mem.end() && in_span(it->first.key))
    it = e->mem.erase(it);
  e->mem_bytes = 0;
  for (auto& kv : e->mem)
    e->mem_bytes += kv.first.key.size() + kv.second.size() + 24;
  std::vector<std::shared_ptr<Run>> kept;
  for (auto& r : e->runs) {
    bool overlaps = false;
    for (auto& ent : *r)
      if (in_span(ent.vk.key)) {
        overlaps = true;
        break;
      }
    if (!overlaps) {
      if (!r->empty()) kept.push_back(r);
      continue;
    }
    auto nr = std::make_shared<Run>();
    for (auto& ent : *r)
      if (!in_span(ent.vk.key)) nr->push_back(ent);
    if (!nr->empty()) kept.push_back(nr);
  }
  e->runs = kept;
  if (e->durable()) {
    // fold the filtered picture into fresh durable state: a new merged
    // run file supersedes every old one, and the WAL (which may still
    // carry span puts) is truncated once its survivors are in a run
    if (!e->mem.empty())
      e->flush();
    else
      e->wal_reset();
    e->compact();
  }
}

// Parse span-format records from `buf` and add them as one ingested run
// (sorted here; duplicates of existing (key, ts) pairs shadow by recency
// exactly like a flushed memtable would).
void eng_ingest_span(void* h, const uint8_t* buf, int64_t len) {
  auto* e = static_cast<Engine*>(h);
  auto run = std::make_shared<Run>();
  int64_t off = 0;
  while (off + 20 <= len) {
    uint32_t klen, vlen, logical;
    uint64_t wall;
    std::memcpy(&klen, buf + off, 4);
    std::memcpy(&vlen, buf + off + 4, 4);
    std::memcpy(&wall, buf + off + 8, 8);
    std::memcpy(&logical, buf + off + 16, 4);
    if (klen > (1u << 20) || vlen > (1u << 28)) break;  // corrupt
    if (off + 20 + (int64_t)klen + (int64_t)vlen > len) break;
    Entry ent;
    ent.vk.key.assign((const char*)buf + off + 20, klen);
    ent.vk.ts = Ts{wall, logical};
    ent.value.assign((const char*)buf + off + 20 + klen, vlen);
    run->push_back(std::move(ent));
    e->n_puts++;
    off += 20 + klen + vlen;
  }
  if (run->empty()) return;
  std::sort(run->begin(), run->end(),
            [](const Entry& a, const Entry& b) { return a.vk < b.vk; });
  e->add_ingested_run(run);
}

void eng_flush(void* h) { static_cast<Engine*>(h)->flush(); }

// what: 0 = total entries (all versions), 1 = number of runs,
//       2 = memtable bytes, 3 = total puts,
//       4 = WAL records replayed at open, 5 = torn-tail bytes truncated
//       at open, 6 = records rejected by CRC (recovery forensics)
uint64_t eng_stats(void* h, int32_t what) {
  auto* e = static_cast<Engine*>(h);
  switch (what) {
    case 0: {
      uint64_t n = e->mem.size();
      for (auto& r : e->runs) n += r->size();
      return n;
    }
    case 1:
      return e->runs.size();
    case 2:
      return e->mem_bytes;
    case 3:
      return e->n_puts;
    case 4:
      return e->wal_replayed;
    case 5:
      return e->torn_bytes;
    case 6:
      return e->crc_failures;
  }
  return 0;
}

}  // extern "C"
