// Shared-memory arena allocator — the plasma-store analogue's native core.
//
// Reference parity: upstream's plasma store manages mmap arenas with an
// allocator + eviction inside the raylet process, and clients map the same
// memory for zero-copy reads (src/ray/object_manager/plasma/ — SURVEY.md
// §2.1 plasma row; mount empty).  Here the arena lives in one /dev/shm
// file: the owning raylet process allocates/frees via this allocator;
// worker processes map the file read-only and read sealed objects
// zero-copy.  Python owns object metadata (id -> offset/size); this layer
// is ONLY the allocator, kept native for speed and for process-shared
// locking (pthread robust mutex in the mapped header).
//
// Layout:  [Header][Block hdr][payload][Block hdr][payload]...
// Free policy: first-fit with block splitting; forward coalescing on free
// (freeing neighbors merges right-adjacent runs; no boundary tags).

#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>

extern "C" {

struct Header {
  uint64_t magic;
  uint64_t capacity;       // total mapped bytes, including this header
  uint64_t data_start;     // offset of the first block header
  uint64_t bytes_in_use;   // sum of allocated payload capacities
  pthread_mutex_t lock;    // process-shared, robust
};

struct Block {
  uint64_t size;   // payload capacity (aligned)
  uint64_t free_;  // 1 = free
};

static const uint64_t kMagic = 0x52415954505541ULL;  // "RAYTPUA"
static const uint64_t kAlign = 64;                   // cache-line payloads

static inline uint64_t align_up(uint64_t x) {
  return (x + kAlign - 1) & ~(kAlign - 1);
}

static void lock_arena(Header* h) {
  int rc = pthread_mutex_lock(&h->lock);
  if (rc == EOWNERDEAD) pthread_mutex_consistent(&h->lock);
}

int arena_init(uint8_t* base, uint64_t capacity) {
  if (capacity < 4096) return -1;
  Header* h = (Header*)base;
  h->magic = kMagic;
  h->capacity = capacity;
  h->data_start = align_up(sizeof(Header));
  h->bytes_in_use = 0;
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  if (pthread_mutex_init(&h->lock, &attr) != 0) return -1;
  Block* b = (Block*)(base + h->data_start);
  b->size = capacity - h->data_start - sizeof(Block);
  b->free_ = 1;
  return 0;
}

int arena_check(uint8_t* base) {
  return ((Header*)base)->magic == kMagic ? 0 : -1;
}

// Returns the PAYLOAD offset (never 0), or 0 when no block fits.
uint64_t arena_alloc(uint8_t* base, uint64_t size) {
  Header* h = (Header*)base;
  uint64_t need = align_up(size ? size : 1);
  lock_arena(h);
  uint64_t off = h->data_start;
  while (off + sizeof(Block) <= h->capacity) {
    Block* b = (Block*)(base + off);
    if (b->free_ && b->size >= need) {
      uint64_t leftover = b->size - need;
      if (leftover > sizeof(Block) + kAlign) {  // split
        Block* nb = (Block*)(base + off + sizeof(Block) + need);
        nb->size = leftover - sizeof(Block);
        nb->free_ = 1;
        b->size = need;
      }
      b->free_ = 0;
      h->bytes_in_use += b->size;
      pthread_mutex_unlock(&h->lock);
      return off + sizeof(Block);
    }
    off += sizeof(Block) + b->size;
  }
  pthread_mutex_unlock(&h->lock);
  return 0;
}

// payload_off must be a value returned by arena_alloc and not yet freed.
int arena_free(uint8_t* base, uint64_t payload_off) {
  Header* h = (Header*)base;
  if (payload_off < h->data_start + sizeof(Block) ||
      payload_off >= h->capacity)
    return -1;
  lock_arena(h);
  uint64_t off = payload_off - sizeof(Block);
  Block* b = (Block*)(base + off);
  if (b->free_) {
    pthread_mutex_unlock(&h->lock);
    return -1;  // double free
  }
  b->free_ = 1;
  h->bytes_in_use -= b->size;
  // forward coalesce
  uint64_t next_off = off + sizeof(Block) + b->size;
  while (next_off + sizeof(Block) <= h->capacity) {
    Block* nb = (Block*)(base + next_off);
    if (!nb->free_) break;
    b->size += sizeof(Block) + nb->size;
    next_off = off + sizeof(Block) + b->size;
  }
  pthread_mutex_unlock(&h->lock);
  return 0;
}

// Touch one byte per page of [offset, offset+size) so first-touch
// faults (tmpfs page allocation + zeroing) are paid here instead of
// inside a landing memcpy.  Reads only — safe concurrent with writers
// to the same range — and called WITHOUT the arena lock: ctypes drops
// the GIL for the call, so a transfer can warm its ingest block on a
// spare core while chunk bytes are in flight.
uint64_t arena_touch(uint8_t* base, uint64_t offset, uint64_t size) {
  const uint64_t kPage = 4096;
  volatile uint8_t acc = 0;
  uint64_t end = offset + size;
  for (uint64_t off = offset; off < end; off += kPage) acc += base[off];
  return acc;
}

uint64_t arena_bytes_in_use(uint8_t* base) {
  return ((Header*)base)->bytes_in_use;
}

uint64_t arena_capacity(uint8_t* base) {
  return ((Header*)base)->capacity;
}

// Largest free payload currently allocatable (for spill decisions).
uint64_t arena_largest_free(uint8_t* base) {
  Header* h = (Header*)base;
  lock_arena(h);
  uint64_t best = 0;
  uint64_t off = h->data_start;
  while (off + sizeof(Block) <= h->capacity) {
    Block* b = (Block*)(base + off);
    if (b->free_ && b->size > best) best = b->size;
    off += sizeof(Block) + b->size;
  }
  pthread_mutex_unlock(&h->lock);
  return best;
}

}  // extern "C"
