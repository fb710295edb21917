// ray_tpu shared-memory object store (plasma-equivalent).
//
// Reference: src/ray/object_manager/plasma (SURVEY.md C12) — an immutable
// node-local object store in shared memory with LRU eviction. TPU-native
// re-design: instead of one mmap'd arena + dlmalloc + fd-passing over a unix
// socket, every object is its own POSIX shm segment (shm_open + mmap).
// Readers in any process map segments directly (zero-copy data plane); the
// control plane (who-has-what) stays in the node manager's gRPC service.
// POSIX keeps a mapping alive after shm_unlink, which gives plasma's
// "eviction never invalidates live readers" property for free.
//
// Exposed as a C API for ctypes (the reference's client is C++ linked via
// Cython; here the binding layer is ctypes per the build constraints).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <unordered_map>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Entry {
  std::string name;       // shm segment name (includes leading '/')
  uint64_t size = 0;
  std::list<std::string>::iterator lru_it;  // position in lru list
};

struct Store {
  std::string prefix;
  uint64_t capacity = 0;
  uint64_t used = 0;
  std::mutex mu;
  std::unordered_map<std::string, Entry> index;  // object id (hex) -> entry
  std::list<std::string> lru;                    // front = most recent
  // Objects mid-write (capacity reserved, segment not yet sealed). Kept out
  // of `index` so readers can never map a partially written segment.
  std::unordered_map<std::string, uint64_t> pending;
};

std::string SegmentName(const Store* s, const std::string& oid) {
  // shm names are limited to NAME_MAX-4; oid hex (56 chars) + prefix fits.
  return "/" + s->prefix + "." + oid;
}

// Unlink + drop one entry (store lock must be held).
void DropLocked(Store* s, std::unordered_map<std::string, Entry>::iterator it) {
  shm_unlink(it->second.name.c_str());
  s->used -= it->second.size;
  s->lru.erase(it->second.lru_it);
  s->index.erase(it);
}

// Evict least-recently-used entries until `need` bytes fit (lock held).
bool EvictLocked(Store* s, uint64_t need) {
  while (s->used + need > s->capacity && !s->lru.empty()) {
    const std::string victim = s->lru.back();
    auto it = s->index.find(victim);
    if (it == s->index.end()) {
      s->lru.pop_back();
      continue;
    }
    DropLocked(s, it);
  }
  return s->used + need <= s->capacity;
}

}  // namespace

extern "C" {

// Create a store handle. `prefix` scopes segment names per node; `capacity`
// bounds total bytes before LRU eviction kicks in.
void* shm_store_create(const char* prefix, uint64_t capacity) {
  auto* s = new Store();
  s->prefix = prefix;
  s->capacity = capacity;
  return s;
}

void shm_store_destroy(void* handle) {
  auto* s = static_cast<Store*>(handle);
  {
    // The guard must release before delete: unlocking a mutex inside the
    // freed Store is a use-after-free (found by the TSAN stress target).
    std::lock_guard<std::mutex> g(s->mu);
    for (auto& kv : s->index) {
      shm_unlink(kv.second.name.c_str());
    }
  }
  delete s;
}

// Create + fill + seal an object. Returns 0 on success, -1 on failure,
// -2 if it cannot fit even after eviction. Writes the segment name into
// name_out (cap name_cap).
int shm_store_put(void* handle, const char* oid, const void* data,
                  uint64_t size, char* name_out, uint64_t name_cap) {
  auto* s = static_cast<Store*>(handle);
  std::string name;
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->index.count(oid)) {  // immutable: re-put is a no-op
      const Entry& e = s->index[oid];
      snprintf(name_out, name_cap, "%s", e.name.c_str());
      return 0;
    }
    name = SegmentName(s, oid);
    if (s->pending.count(oid)) {
      // Another thread is writing the same immutable object; report its
      // name — readers stay safe because lookups miss until it seals.
      snprintf(name_out, name_cap, "%s", name.c_str());
      return 0;
    }
    if (!EvictLocked(s, size)) return -2;
    s->used += size;  // reserve before the copy so parallel puts respect cap
    s->pending.emplace(oid, size);
  }
  // Create + fill OUTSIDE the index: a concurrent Get must never hand a
  // reader the name of a segment that isn't fully written yet (mapping
  // past a short file's end SIGBUSes the reader). Plasma's Create/Seal
  // boundary, collapsed to "insert into the index only once sealed".
  int fd = shm_open(name.c_str(), O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0 && errno == EEXIST) {
    shm_unlink(name.c_str());  // stale segment from a crashed predecessor
    fd = shm_open(name.c_str(), O_CREAT | O_RDWR | O_EXCL, 0600);
  }
  bool ok = fd >= 0 && ftruncate(fd, (off_t)size) == 0;
  if (ok && size > 0) {
    void* dst = mmap(nullptr, size, PROT_WRITE, MAP_SHARED, fd, 0);
    ok = dst != MAP_FAILED;
    if (ok) {
      memcpy(dst, data, size);
      munmap(dst, size);
    }
  }
  if (fd >= 0) close(fd);
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->pending.erase(oid);
    if (!ok) {
      s->used -= size;
      shm_unlink(name.c_str());
      return -1;
    }
    s->lru.push_front(oid);
    Entry e{name, size, s->lru.begin()};
    s->index.emplace(oid, e);
  }
  snprintf(name_out, name_cap, "%s", name.c_str());
  return 0;
}

// Register an object some *other* process already created+sealed (worker-side
// zero-copy put: the worker wrote the segment, the store only indexes it).
int shm_store_register(void* handle, const char* oid, const char* name,
                       uint64_t size) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->index.count(oid)) return 0;
  if (!EvictLocked(s, size)) return -2;
  s->used += size;
  s->lru.push_front(oid);
  Entry e{name, size, s->lru.begin()};
  s->index.emplace(oid, e);
  return 0;
}

// Look up an object. Returns 0 and fills name_out/size_out, or -1 if absent.
// Touches the LRU position.
int shm_store_get(void* handle, const char* oid, char* name_out,
                  uint64_t name_cap, uint64_t* size_out) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->index.find(oid);
  if (it == s->index.end()) return -1;
  s->lru.erase(it->second.lru_it);
  s->lru.push_front(it->first);
  it->second.lru_it = s->lru.begin();
  snprintf(name_out, name_cap, "%s", it->second.name.c_str());
  *size_out = it->second.size;
  return 0;
}

// Object id of the least-recently-used entry (spill victim selection).
// Returns 0 and fills oid_out, or -1 when the store is empty.
int shm_store_coldest(void* handle, char* oid_out, uint64_t oid_cap) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->lru.empty()) return -1;
  snprintf(oid_out, oid_cap, "%s", s->lru.back().c_str());
  return 0;
}

int shm_store_contains(void* handle, const char* oid) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->index.count(oid) ? 1 : 0;
}

int shm_store_delete(void* handle, const char* oid) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->index.find(oid);
  if (it == s->index.end()) return -1;
  DropLocked(s, it);
  return 0;
}

uint64_t shm_store_used(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->used;
}

uint64_t shm_store_count(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->index.size();
}

// ---------------------------------------------------------------- client API
// Map an existing sealed segment read-only. Returns pointer or NULL.
void* shm_client_map(const char* name, uint64_t size) {
  int fd = shm_open(name, O_RDONLY, 0);
  if (fd < 0) return nullptr;
  // Mapping past a short file SIGBUSes on access; a not-fully-written
  // segment (e.g. a concurrent creator between create and seal) must read
  // as "not available yet", not crash the reader.
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < size) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  return p == MAP_FAILED ? nullptr : p;
}

void shm_client_unmap(void* ptr, uint64_t size) {
  if (ptr) munmap(ptr, size);
}

// Worker-side create+write+seal in one call (the client writes the data
// plane itself; only metadata goes to the store — reference: plasma clients
// Create/Seal over shared memory, store.h:55).
// Drop a client-created segment that was never registered with a store
// (e.g. the object was freed before its put flush landed).
int shm_client_unlink(const char* name) { return shm_unlink(name); }

int shm_client_create(const char* name, const void* data, uint64_t size) {
  int fd = shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0 && errno == EEXIST) {
    return 0;  // immutable objects: existing segment is the same content
  }
  if (fd < 0) return -1;
  bool ok = ftruncate(fd, (off_t)size) == 0;
  if (ok && size > 0) {
    void* dst = mmap(nullptr, size, PROT_WRITE, MAP_SHARED, fd, 0);
    ok = dst != MAP_FAILED;
    if (ok) {
      memcpy(dst, data, size);
      munmap(dst, size);
    }
  }
  close(fd);
  if (!ok) {
    shm_unlink(name);
    return -1;
  }
  return 0;
}

}  // extern "C"
