// Host shared-memory object store: the plasma-store equivalent
// (reference: src/ray/object_manager/plasma/ — store.cc,
// object_lifecycle_manager.cc, dlmalloc.cc arena on /dev/shm).
//
// The port's copy of ray_tpu/core/_shm/shm_store.cc. Device tensors stay on
// the card in the process that owns it — this store only holds HOST objects
// (serialized task args/returns, CPU tensors, arrow blocks), so the design
// favors simplicity + zero-copy reads over plasma's full feature set:
//   * one POSIX shm segment (shm_open + mmap), fixed capacity
//   * robust process-shared pthread mutex (survives client crash)
//   * open-addressed hash table of fixed max_objects entries
//   * bump allocator with LRU eviction of sealed, unpinned objects
//   * create -> write into mapped memory -> seal; get pins, release unpins
//
// C ABI for ctypes (no pybind11 in the image).

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x52545055;  // "RTPU"
constexpr int kIdSize = 20;

struct Entry {
  uint8_t id[kIdSize];
  uint64_t offset;      // data offset from arena base
  uint64_t size;
  int64_t lru_tick;     // last touch; -1 = free slot
  int32_t pins;         // readers holding the buffer
  uint8_t sealed;       // visible to get() only when sealed
  uint8_t used;         // slot occupied
  uint8_t pad[2];
};

struct Header {
  uint32_t magic;
  uint32_t max_objects;
  uint64_t capacity;        // arena bytes
  uint64_t bump;            // next free offset (monotonic until wrap)
  uint64_t live_bytes;
  int64_t tick;             // LRU clock
  pthread_mutex_t mutex;    // process-shared, robust
  // Entry table follows; arena follows that.
};

struct Store {
  Header* hdr;
  Entry* entries;
  uint8_t* arena;
  uint64_t map_size;
  int fd;
  char name[256];
  bool owner;
};

uint64_t TableBytes(uint32_t max_objects) {
  return sizeof(Header) + uint64_t(max_objects) * sizeof(Entry);
}

uint32_t Hash(const uint8_t* id) {
  // FNV-1a over the 20-byte id
  uint32_t h = 2166136261u;
  for (int i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 16777619u;
  }
  return h;
}

Entry* FindSlot(Store* s, const uint8_t* id, bool for_insert) {
  uint32_t n = s->hdr->max_objects;
  uint32_t idx = Hash(id) % n;
  Entry* first_free = nullptr;
  for (uint32_t probe = 0; probe < n; probe++) {
    Entry* e = &s->entries[(idx + probe) % n];
    if (e->used) {
      if (memcmp(e->id, id, kIdSize) == 0) return e;
    } else {
      if (!for_insert) {
        // keep probing: deleted slots use used=0 but sealed=2 tombstone
        if (e->sealed != 2) return nullptr;
        continue;
      }
      if (first_free == nullptr) first_free = e;
      if (e->sealed != 2) return first_free;  // true end of chain
    }
  }
  return for_insert ? first_free : nullptr;
}

void Lock(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) pthread_mutex_consistent(&s->hdr->mutex);
}

void Unlock(Store* s) { pthread_mutex_unlock(&s->hdr->mutex); }

// Try to reclaim `needed` contiguous bytes at the end of the arena by
// evicting sealed+unpinned objects (oldest first) and compacting. Returns
// the offset to place the new object at, or UINT64_MAX.
uint64_t ReserveSpace(Store* s, uint64_t needed) {
  Header* h = s->hdr;
  if (needed > h->capacity) return UINT64_MAX;
  if (h->bump + needed <= h->capacity) {
    uint64_t off = h->bump;
    h->bump += needed;
    return off;
  }
  // Evict LRU sealed/unpinned until (live bytes + needed) fits, then compact.
  while (h->live_bytes + needed > h->capacity) {
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < h->max_objects; i++) {
      Entry* e = &s->entries[i];
      if (e->used && e->sealed == 1 && e->pins == 0) {
        if (victim == nullptr || e->lru_tick < victim->lru_tick) victim = e;
      }
    }
    if (victim == nullptr) return UINT64_MAX;  // everything pinned/unsealed
    h->live_bytes -= victim->size;
    victim->used = 0;
    victim->sealed = 2;  // tombstone for probe chains
  }
  // Compact: slide surviving objects down in offset order (stable).
  // Collect used entries sorted by offset (insertion sort; table is small).
  uint32_t n = h->max_objects;
  Entry** order = new Entry*[n];
  uint32_t m = 0;
  for (uint32_t i = 0; i < n; i++)
    if (s->entries[i].used) order[m++] = &s->entries[i];
  for (uint32_t i = 1; i < m; i++) {
    Entry* key = order[i];
    uint32_t j = i;
    while (j > 0 && order[j - 1]->offset > key->offset) {
      order[j] = order[j - 1];
      j--;
    }
    order[j] = key;
  }
  // Slide only movable objects (sealed, unpinned). Pinned/unsealed entries
  // have live raw pointers outstanding and act as barriers; processing in
  // offset order keeps targets clear of every earlier entry, moved or not.
  uint64_t cursor = 0;
  for (uint32_t i = 0; i < m; i++) {
    Entry* e = order[i];
    if (e->pins > 0 || e->sealed != 1) {
      cursor = e->offset + e->size;
      continue;
    }
    if (e->offset != cursor) {
      memmove(s->arena + cursor, s->arena + e->offset, e->size);
      e->offset = cursor;
    }
    cursor += e->size;
  }
  delete[] order;
  h->bump = cursor;
  if (h->bump + needed > h->capacity) return UINT64_MAX;
  uint64_t off = h->bump;
  h->bump += needed;
  return off;
}

}  // namespace

extern "C" {

// Create (owner) or open a store. Returns opaque handle or null.
void* shm_store_create(const char* name, uint64_t capacity, uint32_t max_objects) {
  shm_unlink(name);  // fresh
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = TableBytes(max_objects) + capacity;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Store* s = new Store();
  s->hdr = (Header*)base;
  s->entries = (Entry*)((uint8_t*)base + sizeof(Header));
  s->arena = (uint8_t*)base + TableBytes(max_objects);
  s->map_size = total;
  s->fd = fd;
  s->owner = true;
  strncpy(s->name, name, sizeof(s->name) - 1);

  memset(s->hdr, 0, TableBytes(max_objects));
  s->hdr->magic = kMagic;
  s->hdr->max_objects = max_objects;
  s->hdr->capacity = capacity;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&s->hdr->mutex, &attr);
  pthread_mutexattr_destroy(&attr);
  return s;
}

void* shm_store_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Header* hdr = (Header*)base;
  if (hdr->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->hdr = hdr;
  s->entries = (Entry*)((uint8_t*)base + sizeof(Header));
  s->arena = (uint8_t*)base + TableBytes(hdr->max_objects);
  s->map_size = (uint64_t)st.st_size;
  s->fd = fd;
  s->owner = false;
  strncpy(s->name, name, sizeof(s->name) - 1);
  return s;
}

// Reserve an object buffer; returns writable pointer or null (exists/full).
void* shm_obj_create(void* handle, const uint8_t* id, uint64_t size) {
  Store* s = (Store*)handle;
  Lock(s);
  Entry* e = FindSlot(s, id, true);
  if (e != nullptr && e->used && memcmp(e->id, id, kIdSize) == 0) {
    Unlock(s);
    return nullptr;  // duplicate
  }
  if (e == nullptr) {
    // Table full: evict the LRU sealed+unpinned entry. ReserveSpace only
    // evicts under BYTE pressure — many small sealed objects can exhaust
    // the slot table long before the arena fills, and without this path
    // the store would refuse all new objects forever.
    Entry* victim = nullptr;
    for (uint32_t i = 0; i < s->hdr->max_objects; i++) {
      Entry* c = &s->entries[i];
      if (c->used && c->sealed == 1 && c->pins == 0) {
        if (victim == nullptr || c->lru_tick < victim->lru_tick) victim = c;
      }
    }
    if (victim == nullptr) {
      Unlock(s);
      return nullptr;  // everything pinned/unsealed
    }
    s->hdr->live_bytes -= victim->size;
    victim->used = 0;
    victim->sealed = 2;  // tombstone for probe chains
    e = FindSlot(s, id, true);
    if (e == nullptr) {
      Unlock(s);
      return nullptr;
    }
  }
  uint64_t off = ReserveSpace(s, size);
  if (off == UINT64_MAX) {
    Unlock(s);
    return nullptr;
  }
  memcpy(e->id, id, kIdSize);
  e->offset = off;
  e->size = size;
  e->pins = 1;  // creator holds it until seal
  e->sealed = 0;
  e->used = 1;
  e->lru_tick = ++s->hdr->tick;
  s->hdr->live_bytes += size;
  void* ptr = s->arena + off;
  Unlock(s);
  return ptr;
}

int shm_obj_seal(void* handle, const uint8_t* id) {
  Store* s = (Store*)handle;
  Lock(s);
  Entry* e = FindSlot(s, id, false);
  if (e == nullptr || !e->used || e->sealed == 1) {
    Unlock(s);
    return -1;
  }
  e->sealed = 1;
  e->pins = 0;
  e->lru_tick = ++s->hdr->tick;
  Unlock(s);
  return 0;
}

// Pinning get: returns pointer or null; *size_out set on success.
void* shm_obj_get(void* handle, const uint8_t* id, uint64_t* size_out) {
  Store* s = (Store*)handle;
  Lock(s);
  Entry* e = FindSlot(s, id, false);
  if (e == nullptr || !e->used || e->sealed != 1) {
    Unlock(s);
    return nullptr;
  }
  e->pins++;
  e->lru_tick = ++s->hdr->tick;
  *size_out = e->size;
  void* ptr = s->arena + e->offset;
  Unlock(s);
  return ptr;
}

int shm_obj_release(void* handle, const uint8_t* id) {
  Store* s = (Store*)handle;
  Lock(s);
  Entry* e = FindSlot(s, id, false);
  if (e == nullptr || !e->used || e->pins <= 0) {
    Unlock(s);
    return -1;
  }
  e->pins--;
  Unlock(s);
  return 0;
}

int shm_obj_delete(void* handle, const uint8_t* id) {
  Store* s = (Store*)handle;
  Lock(s);
  Entry* e = FindSlot(s, id, false);
  if (e == nullptr || !e->used || e->pins > 0) {
    Unlock(s);
    return -1;
  }
  s->hdr->live_bytes -= e->size;
  e->used = 0;
  e->sealed = 2;  // tombstone
  Unlock(s);
  return 0;
}

int shm_obj_contains(void* handle, const uint8_t* id) {
  Store* s = (Store*)handle;
  Lock(s);
  Entry* e = FindSlot(s, id, false);
  int ok = (e != nullptr && e->used && e->sealed == 1) ? 1 : 0;
  Unlock(s);
  return ok;
}

uint64_t shm_store_live_bytes(void* handle) {
  Store* s = (Store*)handle;
  Lock(s);
  uint64_t v = s->hdr->live_bytes;
  Unlock(s);
  return v;
}

uint64_t shm_store_capacity(void* handle) {
  return ((Store*)handle)->hdr->capacity;
}

void shm_store_close(void* handle) {
  Store* s = (Store*)handle;
  munmap((void*)s->hdr, s->map_size);
  close(s->fd);
  if (s->owner) shm_unlink(s->name);
  delete s;
}

}  // extern "C"
