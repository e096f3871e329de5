// Read-only LMDB (data.mdb) parser.
//
// The reference framework stores all pre-extracted features in LMDB
// environments (reference datasets/reader_fns.py:54) and reads them through
// the `lmdb` Python binding, which is not available in this image. This is a
// from-scratch reader for the on-disk format of LMDB 0.9.x on 64-bit
// little-endian hosts: mmap the file, pick the live meta page, walk the
// B+tree. Returned value pointers alias the mapping (zero-copy); Python
// binds via ctypes (afft_tpu_torch/data/lmdb_native.py).
//
// Format notes (liblmdb mdb.c):
//  - pages 0/1 are meta pages; the one with the higher txnid is live;
//  - the page size is recorded in mm_dbs[FREE_DBI].md_pad;
//  - page header: pgno u64, pad u16, flags u16, {lower u16, upper u16};
//  - node: lo u16, hi u16, flags u16, ksize u16, key[], data[];
//  - branch child pgno = lo | hi<<16 | flags<<32; leaf data size = lo|hi<<16;
//  - F_BIGDATA leaves store an 8-byte overflow pgno after the key; overflow
//    pages hold the value contiguously after one 16-byte header.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kMagicSwapped = 0xDEC0EFBE;  // big-endian-written file
constexpr uint32_t kDataVersion = 1;            // liblmdb MDB_DATA_VERSION
constexpr uint16_t kPageBranch = 0x01;
constexpr uint16_t kPageLeaf = 0x02;
constexpr uint16_t kPageOverflow = 0x04;
constexpr uint16_t kPageLeaf2 = 0x20;  // MDB_DUPFIXED sub-page layout
constexpr uint16_t kNodeBigData = 0x01;
constexpr uint16_t kNodeSubData = 0x02;  // named sub-database entry
constexpr uint16_t kNodeDupData = 0x04;  // MDB_DUPSORT duplicate blob
constexpr size_t kPageHdrSize = 16;

// main-DB flags we cannot serve: each changes key comparison or value
// layout, so misparsing is guaranteed rather than merely possible
constexpr uint16_t kDbReverseKey = 0x02;
constexpr uint16_t kDbDupSort = 0x04;
constexpr uint16_t kDbIntegerKey = 0x08;
constexpr uint16_t kDbDupFixed = 0x10;
constexpr uint16_t kDbIntegerDup = 0x20;
constexpr uint16_t kDbReverseDup = 0x40;

thread_local char g_err[512] = "";

void set_err(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(g_err, sizeof(g_err), fmt, ap);
  va_end(ap);
}

struct Db {  // MDB_db, 48 bytes
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
} __attribute__((packed));

struct Meta {  // MDB_meta after the page header
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  Db dbs[2];
  uint64_t last_pg;
  uint64_t txnid;
} __attribute__((packed));

struct Env {
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t psize = 0;
  uint64_t root = ~0ull;
  uint64_t entries = 0;
  int fd = -1;
};

inline const uint8_t* page(const Env* env, uint64_t pgno) {
  size_t off = pgno * env->psize;
  if (off + env->psize > env->size) return nullptr;
  return env->map + off;
}

inline uint16_t rd16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

inline uint16_t page_flags(const uint8_t* pg) { return rd16(pg + 10); }
inline size_t num_keys(const uint8_t* pg) {
  return (rd16(pg + 12) - kPageHdrSize) >> 1;
}
inline const uint8_t* node_at(const uint8_t* pg, size_t i) {
  return pg + rd16(pg + kPageHdrSize + 2 * i);
}
inline uint64_t branch_pgno(const uint8_t* node) {
  return (uint64_t)rd16(node) | ((uint64_t)rd16(node + 2) << 16) |
         ((uint64_t)rd16(node + 4) << 32);
}
inline size_t leaf_data_size(const uint8_t* node) {
  return (size_t)rd16(node) | ((size_t)rd16(node + 2) << 16);
}
inline uint16_t node_flags(const uint8_t* node) { return rd16(node + 4); }
inline size_t node_ksize(const uint8_t* node) { return rd16(node + 6); }
inline const uint8_t* node_key(const uint8_t* node) { return node + 8; }

// liblmdb default comparator (mdb_cmp_memn): memcmp, shorter key first
int cmp_keys(const uint8_t* a, size_t alen, const uint8_t* b, size_t blen) {
  size_t n = alen < blen ? alen : blen;
  int r = memcmp(a, b, n);
  if (r) return r;
  return (alen < blen) ? -1 : (alen > blen ? 1 : 0);
}

}  // namespace

extern "C" {

const char* afft_lmdb_last_error() { return g_err; }

void* afft_lmdb_open(const char* path) {
  g_err[0] = '\0';
  std::string fname = std::string(path);
  struct stat st;
  if (stat(fname.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) {
    fname += "/data.mdb";
  }
  int fd = open(fname.c_str(), O_RDONLY);
  if (fd < 0) {
    set_err("cannot open %s", fname.c_str());
    return nullptr;
  }
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)(2 * 512)) {
    set_err("%s: too small for an LMDB environment (%lld bytes; need two "
            "meta pages)", fname.c_str(), (long long)st.st_size);
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    set_err("%s: mmap failed", fname.c_str());
    close(fd);
    return nullptr;
  }
  auto* env = new Env();
  env->map = static_cast<const uint8_t*>(map);
  env->size = st.st_size;
  env->fd = fd;

  auto fail = [&](void) -> void* {
    delete env;
    munmap(map, st.st_size);
    close(fd);
    return nullptr;
  };

  // Meta selection with torn-write recovery. liblmdb alternates the two
  // meta pages by txn parity, so a crash mid-commit can tear EITHER one
  // (including page 0). Each candidate is validated in full — magic,
  // version, plausible recorded page size, root within the file — and the
  // live meta is the highest-txnid candidate that passes; a single torn
  // meta therefore rolls back to the previous committed state instead of
  // failing the open (what a liblmdb reopen after the same crash does).
  auto meta_check = [&](size_t off, size_t want_psize, const Meta** out,
                        char* why, size_t whysz) -> bool {
    *out = nullptr;
    if (off + kPageHdrSize + sizeof(Meta) > (size_t)st.st_size) {
      snprintf(why, whysz, "meta page at offset %zu beyond end of file", off);
      return false;
    }
    const Meta* m = reinterpret_cast<const Meta*>(env->map + off +
                                                  kPageHdrSize);
    if (m->magic == kMagicSwapped) {
      snprintf(why, whysz,
               "byte-swapped LMDB magic — file was written on a big-endian "
               "host; this reader only parses little-endian environments");
      return false;
    }
    if (m->magic != kMagic) {
      snprintf(why, whysz,
               "bad LMDB magic 0x%08X (expected 0x%08X); not an LMDB data "
               "file or corrupt", m->magic, kMagic);
      return false;
    }
    if (m->version != kDataVersion) {
      snprintf(why, whysz,
               "LMDB data-format version %u; this reader implements version "
               "%u (liblmdb 0.9.x). Refusing to guess at layout differences.",
               m->version, kDataVersion);
      return false;
    }
    size_t ps = m->dbs[0].pad;
    if (ps < 512 || ps > (1u << 16) || (ps & (ps - 1)) != 0) {
      snprintf(why, whysz,
               "implausible page size %zu in meta (expect power of two in "
               "[512, 65536]); corrupt meta page", ps);
      return false;
    }
    if (want_psize && ps != want_psize) {
      snprintf(why, whysz, "meta records page size %zu, expected %zu", ps,
               want_psize);
      return false;
    }
    uint64_t root = m->dbs[1].root;
    if (root != ~0ull && (root + 1) * ps > (size_t)st.st_size) {
      snprintf(why, whysz,
               "main DB root page %llu beyond end of file (torn meta write)",
               (unsigned long long)root);
      return false;
    }
    *out = m;
    return true;
  };

  char why0[256], why1[256];
  const Meta* m0 = nullptr;
  const Meta* m1 = nullptr;
  bool ok0 = meta_check(0, 0, &m0, why0, sizeof(why0));
  bool ok1 = false;
  if (ok0) {
    ok1 = meta_check(m0->dbs[0].pad, m0->dbs[0].pad, &m1, why1, sizeof(why1));
  } else {
    // meta 0 is the torn one: its recorded page size is untrustworthy, so
    // probe every legal page size for a meta 1 that records that same size
    snprintf(why1, sizeof(why1), "meta page 1 not found (meta 0 torn)");
    for (size_t ps = 512; ps <= (1u << 16); ps <<= 1) {
      if (meta_check(ps, ps, &m1, why1, sizeof(why1))) {
        ok1 = true;
        break;
      }
    }
  }
  if (!ok0 && !ok1) {
    set_err("%s: no valid meta page: meta 0: %s / meta 1: %s", fname.c_str(),
            why0, why1);
    return fail();
  }
  const Meta* live = (ok0 && ok1) ? (m1->txnid > m0->txnid ? m1 : m0)
                                  : (ok0 ? m0 : m1);
  env->psize = live->dbs[0].pad;
  if ((size_t)st.st_size < 2 * env->psize) {
    set_err("%s: file smaller than two %zu-byte meta pages", fname.c_str(),
            env->psize);
    return fail();
  }
  uint16_t dbflags = live->dbs[1].flags;
  uint16_t bad = dbflags & (kDbReverseKey | kDbDupSort | kDbIntegerKey |
                            kDbDupFixed | kDbIntegerDup | kDbReverseDup);
  if (bad) {
    set_err("%s: main DB uses unsupported flags 0x%04X (%s%s%s%s%s%s); "
            "this reader only serves default-comparator non-DUPSORT "
            "environments like the RULSTM feature stores",
            fname.c_str(), dbflags,
            (bad & kDbReverseKey) ? "MDB_REVERSEKEY " : "",
            (bad & kDbDupSort) ? "MDB_DUPSORT " : "",
            (bad & kDbIntegerKey) ? "MDB_INTEGERKEY " : "",
            (bad & kDbDupFixed) ? "MDB_DUPFIXED " : "",
            (bad & kDbIntegerDup) ? "MDB_INTEGERDUP " : "",
            (bad & kDbReverseDup) ? "MDB_REVERSEDUP " : "");
    return fail();
  }
  env->root = live->dbs[1].root;
  env->entries = live->dbs[1].entries;
  if (env->root != ~0ull && env->root * env->psize >= (size_t)st.st_size) {
    set_err("%s: main DB root page %llu beyond end of file", fname.c_str(),
            (unsigned long long)env->root);
    return fail();
  }
  return env;
}

void afft_lmdb_close(void* handle) {
  auto* env = static_cast<Env*>(handle);
  if (!env) return;
  munmap(const_cast<uint8_t*>(env->map), env->size);
  close(env->fd);
  delete env;
}

uint64_t afft_lmdb_entries(void* handle) {
  return static_cast<Env*>(handle)->entries;
}

namespace {

// Shared leaf-node value extraction with layout validation. Returns 1 on
// success, -1 (with g_err set) on any unsupported/corrupt layout.
int leaf_value(const Env* env, const uint8_t* node, const uint8_t** val,
               size_t* vlen) {
  uint16_t nf = node_flags(node);
  if (nf & kNodeSubData) {
    set_err("leaf node is a named sub-database entry (F_SUBDATA); this "
            "reader serves the main DB only — open the sub-database with "
            "real liblmdb");
    return -1;
  }
  if (nf & kNodeDupData) {
    set_err("leaf node carries MDB_DUPSORT duplicate data (F_DUPDATA); "
            "unsupported layout");
    return -1;
  }
  size_t dsize = leaf_data_size(node);
  if (nf & kNodeBigData) {
    uint64_t opg = rd64(node_key(node) + node_ksize(node));
    const uint8_t* ov = page(env, opg);
    if (!ov) {
      set_err("overflow page %llu beyond end of file",
              (unsigned long long)opg);
      return -1;
    }
    if (!(page_flags(ov) & kPageOverflow)) {
      set_err("page %llu referenced as overflow has flags 0x%04X "
              "(not P_OVERFLOW); corrupt tree", (unsigned long long)opg,
              page_flags(ov));
      return -1;
    }
    if (opg * env->psize + kPageHdrSize + dsize > env->size) {
      set_err("overflow value (%zu bytes at page %llu) extends beyond end "
              "of file", dsize, (unsigned long long)opg);
      return -1;
    }
    *val = ov + kPageHdrSize;
  } else {
    if ((size_t)(node - env->map) + 8 + node_ksize(node) + dsize >
        env->size) {
      set_err("inline value extends beyond end of file; corrupt node");
      return -1;
    }
    *val = node_key(node) + node_ksize(node);
  }
  *vlen = dsize;
  return 1;
}

// Page sanity shared by point reads and cursor scans.
bool check_node_page(const Env* env, const uint8_t* pg) {
  uint16_t flags = page_flags(pg);
  if (flags & kPageLeaf2) {
    set_err("P_LEAF2 page (MDB_DUPFIXED fixed-size layout); unsupported");
    return false;
  }
  uint16_t lower = rd16(pg + 12);
  if (lower < kPageHdrSize || lower > env->psize) {
    set_err("page ptr-array bound %u outside [%zu, %zu]; corrupt page "
            "header", lower, kPageHdrSize, env->psize);
    return false;
  }
  return true;
}

}  // namespace

// Returns 1 and sets (*val, *vlen) on hit; 0 on miss; -1 on corruption.
int afft_lmdb_get(void* handle, const uint8_t* key, size_t klen,
                  const uint8_t** val, size_t* vlen) {
  auto* env = static_cast<Env*>(handle);
  if (env->root == ~0ull) return 0;  // empty db
  const uint8_t* pg = page(env, env->root);
  if (!pg) {
    set_err("root page beyond end of file");
    return -1;
  }
  for (int depth = 0; depth < 64; ++depth) {
    if (!check_node_page(env, pg)) return -1;
    uint16_t flags = page_flags(pg);
    size_t n = num_keys(pg);
    if (flags & kPageBranch) {
      // find last child whose key <= search key (child 0 key is empty)
      size_t lo = 1, hi = n, child = 0;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        const uint8_t* node = node_at(pg, mid);
        int c = cmp_keys(key, klen, node_key(node), node_ksize(node));
        if (c < 0) hi = mid; else lo = mid + 1;
      }
      child = lo - 1;
      pg = page(env, branch_pgno(node_at(pg, child)));
      if (!pg) {
        set_err("branch child page beyond end of file");
        return -1;
      }
      continue;
    }
    if (flags & kPageLeaf) {
      size_t lo = 0, hi = n;
      while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        const uint8_t* node = node_at(pg, mid);
        int c = cmp_keys(key, klen, node_key(node), node_ksize(node));
        if (c == 0) return leaf_value(env, node, val, vlen);
        if (c < 0) hi = mid; else lo = mid + 1;
      }
      return 0;
    }
    set_err("unexpected page flags 0x%04X in tree walk (neither branch nor "
            "leaf)", flags);
    return -1;
  }
  set_err("B+tree deeper than 64 levels; cyclic page references");
  return -1;
}

// --- full scan (for the packer) -------------------------------------------

struct Cursor {
  Env* env;
  // stack of (pgno, index) down the tree
  uint64_t pgnos[64];
  size_t idxs[64];
  int depth = -1;
  bool done = false;
};

void* afft_lmdb_cursor_open(void* handle) {
  auto* env = static_cast<Env*>(handle);
  auto* cur = new Cursor();
  cur->env = env;
  if (env->root == ~0ull) {
    cur->done = true;
    return cur;
  }
  // descend to leftmost leaf
  uint64_t pgno = env->root;
  while (true) {
    const uint8_t* pg = page(env, pgno);
    if (!pg) { cur->done = true; return cur; }
    cur->depth += 1;
    cur->pgnos[cur->depth] = pgno;
    cur->idxs[cur->depth] = 0;
    if (page_flags(pg) & kPageLeaf) break;
    pgno = branch_pgno(node_at(pg, 0));
  }
  return cur;
}

// Returns 1 with (key, val) on success, 0 at end of iteration, -1 (error
// text via afft_lmdb_last_error) on corrupt/unsupported layout.
int afft_lmdb_cursor_next(void* handle, const uint8_t** key, size_t* klen,
                          const uint8_t** val, size_t* vlen) {
  auto* cur = static_cast<Cursor*>(handle);
  if (cur->done) return 0;
  Env* env = cur->env;
  const uint8_t* pg = page(env, cur->pgnos[cur->depth]);
  if (!check_node_page(env, pg)) { cur->done = true; return -1; }
  size_t i = cur->idxs[cur->depth];
  if (i >= num_keys(pg)) {
    // pop until we can advance a branch index
    while (true) {
      cur->depth -= 1;
      if (cur->depth < 0) { cur->done = true; return 0; }
      const uint8_t* parent = page(env, cur->pgnos[cur->depth]);
      size_t pi = cur->idxs[cur->depth] + 1;
      if (pi < num_keys(parent)) {
        cur->idxs[cur->depth] = pi;
        uint64_t pgno = branch_pgno(node_at(parent, pi));
        // descend leftmost
        while (true) {
          const uint8_t* child = page(env, pgno);
          if (!child) {
            set_err("cursor: child page beyond end of file");
            cur->done = true;
            return -1;
          }
          if (!check_node_page(env, child)) { cur->done = true; return -1; }
          cur->depth += 1;
          cur->pgnos[cur->depth] = pgno;
          cur->idxs[cur->depth] = 0;
          if (page_flags(child) & kPageLeaf) break;
          pgno = branch_pgno(node_at(child, 0));
        }
        pg = page(env, cur->pgnos[cur->depth]);
        i = 0;
        break;
      }
    }
  }
  const uint8_t* node = node_at(pg, i);
  *key = node_key(node);
  *klen = node_ksize(node);
  int rc = leaf_value(env, node, val, vlen);
  if (rc < 0) { cur->done = true; return -1; }
  cur->idxs[cur->depth] = i + 1;
  return 1;
}

void afft_lmdb_cursor_close(void* handle) {
  delete static_cast<Cursor*>(handle);
}

}  // extern "C"
