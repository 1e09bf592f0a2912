// Native string-interning registry: name -> dense row id with LRU eviction,
// pinning, and an evicted-row queue — behavior-identical to the Python
// Registry in sentinel_tpu_torch/core/registry.py (which mirrors the reference's
// copy-on-write name maps, CtSph.java:202-226, minus the silent 6,000-chain
// cap). This is the one host-side hot path worth native code (SURVEY §7
// hard part 5: name->id at tens of millions/sec feeds the batched device
// step); everything device-side stays PyTorch and CUDA. The JAX package
// holds the same file (sentinel_tpu/native/src/registry.cpp).
//
// C ABI only (loaded via ctypes): no CPython API, so the GIL is naturally
// released for the duration of every call made through ctypes.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC registry.cpp -o <lib>.so
// (sentinel_tpu_torch/ops/_build.build_host, into sentinel_tpu_torch/_build/)

#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

namespace {

// FNV-1a 64
static inline uint64_t fnv1a(const char* s, int len) {
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < len; ++i) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ull;
    }
    return h;
}

struct Entry {
    char*    name = nullptr;     // owned copy, NUL-terminated
    int      len = 0;
    int32_t  id = -1;            // row id
    // intrusive LRU list over *occupied* entries (most recent at tail)
    int32_t  prev = -1;          // index into slots_, -1 = none
    int32_t  next = -1;
    bool     pinned = false;     // string-API pin (rule resources: sticky)
    uint32_t pin_count = 0;      // row-API counted pins (in-flight entries)
};

struct Table {
    std::mutex mu;
    int32_t capacity;            // max live names (== row id space)
    std::vector<int32_t> buckets;   // open addressing: slot index or -1
    std::vector<Entry> slots;       // slot i owns row id i (dense!)
    std::vector<int32_t> evicted;   // pending drain
    int32_t next_id = 0;
    int32_t lru_head = -1;          // least recently used
    int32_t lru_tail = -1;          // most recently used
    int32_t live = 0;

    explicit Table(int32_t cap)
        : capacity(cap), slots(cap) {
        // bucket table sized to >= 2x capacity, power of two
        size_t n = 8;
        while (n < (size_t)cap * 2) n <<= 1;
        buckets.assign(n, -1);
    }
    ~Table() {
        for (auto& e : slots) delete[] e.name;
    }

    inline size_t mask() const { return buckets.size() - 1; }

    // --- LRU list ---------------------------------------------------------
    void lru_unlink(int32_t i) {
        Entry& e = slots[i];
        if (e.prev >= 0) slots[e.prev].next = e.next; else lru_head = e.next;
        if (e.next >= 0) slots[e.next].prev = e.prev; else lru_tail = e.prev;
        e.prev = e.next = -1;
    }
    void lru_push_tail(int32_t i) {
        Entry& e = slots[i];
        e.prev = lru_tail;
        e.next = -1;
        if (lru_tail >= 0) slots[lru_tail].next = i; else lru_head = i;
        lru_tail = i;
    }

    // --- buckets ----------------------------------------------------------
    // find the bucket holding `name`, or the first empty bucket.
    size_t probe(const char* name, int len, bool* found) const {
        size_t i = fnv1a(name, len) & mask();
        for (;;) {
            int32_t s = buckets[i];
            if (s < 0) { *found = false; return i; }
            const Entry& e = slots[s];
            if (e.len == len && std::memcmp(e.name, name, len) == 0) {
                *found = true;
                return i;
            }
            i = (i + 1) & mask();
        }
    }
    void bucket_erase(const char* name, int len) {
        // tombstone-free deletion for linear probing (backward shift)
        bool found;
        size_t i = probe(name, len, &found);
        if (!found) return;
        size_t j = i;
        for (;;) {
            j = (j + 1) & mask();
            int32_t s = buckets[j];
            if (s < 0) break;
            size_t home = fnv1a(slots[s].name, slots[s].len) & mask();
            // can slot j's entry be moved into the hole at i?
            bool wraps = (j < home);
            bool between = wraps ? (i >= home || i < j) : (i >= home && i < j);
            if (between) {
                buckets[i] = s;
                i = j;
            }
        }
        buckets[i] = -1;
    }

    // --- core ops ---------------------------------------------------------
    int32_t evict_locked() {
        for (int32_t i = lru_head; i >= 0; i = slots[i].next) {
            if (!slots[i].pinned && slots[i].pin_count == 0) {
                Entry& e = slots[i];
                bucket_erase(e.name, e.len);
                lru_unlink(i);
                delete[] e.name;
                e.name = nullptr;
                e.len = 0;
                --live;
                evicted.push_back(e.id);
                return i;                      // slot index == row id
            }
        }
        return -2;                             // all pinned
    }

    // touch_on_hit: only the plain get_or_create path refreshes LRU order on
    // a hit — lookup() and pin() leave order untouched, exactly like the
    // Python Registry (move_to_end only in get_or_create)
    int32_t get_or_create(const char* name, int len, bool create, bool pin,
                          bool touch_on_hit) {
        bool found;
        size_t b = probe(name, len, &found);
        if (found) {
            int32_t s = buckets[b];
            if (touch_on_hit) {
                lru_unlink(s);
                lru_push_tail(s);
            }
            if (pin) slots[s].pinned = true;
            return slots[s].id;
        }
        if (!create) return -1;
        int32_t slot;
        if (next_id < capacity) {
            slot = next_id++;
        } else {
            slot = evict_locked();
            if (slot < 0) return -2;
            // eviction may have shifted buckets: re-probe for our insert slot
            b = probe(name, len, &found);
        }
        Entry& e = slots[slot];
        e.name = new char[len + 1];
        std::memcpy(e.name, name, len);
        e.name[len] = '\0';
        e.len = len;
        e.id = slot;
        e.pinned = pin;
        // pin_count deliberately NOT reset: counted row pins are
        // independent of key liveness (a pin taken on a row protects its
        // next occupant too — exactly the Python registry's _pins dict)
        buckets[b] = slot;
        lru_push_tail(slot);
        ++live;
        return slot;
    }

    // get_or_create that also reports creation (param-key overrides apply
    // only when the key is newly interned)
    int32_t get_or_create2(const char* name, int len, uint8_t* created) {
        bool found;
        probe(name, len, &found);
        *created = found ? 0 : 1;
        return get_or_create(name, len, /*create=*/true, /*pin=*/false,
                             /*touch_on_hit=*/true);
    }
};

}  // namespace

extern "C" {

void* str_new(int32_t capacity) {
    if (capacity < 1) return nullptr;
    return new (std::nothrow) Table(capacity);
}

void str_free(void* h) { delete static_cast<Table*>(h); }

int32_t str_get_or_create(void* h, const char* name, int32_t len) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    return t->get_or_create(name, len, /*create=*/true, /*pin=*/false,
                            /*touch_on_hit=*/true);
}

int32_t str_lookup(void* h, const char* name, int32_t len) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    return t->get_or_create(name, len, /*create=*/false, /*pin=*/false,
                            /*touch_on_hit=*/false);
}

int32_t str_pin(void* h, const char* name, int32_t len) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    return t->get_or_create(name, len, /*create=*/true, /*pin=*/true,
                            /*touch_on_hit=*/false);
}

void str_unpin(void* h, const char* name, int32_t len) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    bool found;
    size_t b = t->probe(name, len, &found);
    if (found) t->slots[t->buckets[b]].pinned = false;
}

// touch-free read of one id's name; returns length or -1; copies at most
// buflen bytes (no NUL) into buf.
int32_t str_name_of(void* h, int32_t id, char* buf, int32_t buflen) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    if (id < 0 || id >= t->capacity) return -1;
    const Entry& e = t->slots[id];
    if (e.name == nullptr) return -1;
    int32_t n = e.len < buflen ? e.len : buflen;
    std::memcpy(buf, e.name, n);
    return e.len;
}

int32_t str_len(void* h) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    return t->live;
}

// drain evicted ids into out (up to cap); returns count written; remaining
// stay queued.
int32_t str_drain(void* h, int32_t* out, int32_t cap) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    int32_t n = (int32_t)t->evicted.size();
    if (n > cap) n = cap;
    std::memcpy(out, t->evicted.data(), n * sizeof(int32_t));
    t->evicted.erase(t->evicted.begin(), t->evicted.begin() + n);
    return n;
}

// batch get_or_create: names concatenated in `data`, offsets[n+1] bounds.
// Returns number processed (== n unless a row allocation failed, where the
// failing and remaining entries get id -2 and processing continues).
int32_t str_get_or_create_batch(void* h, const char* data,
                                const int32_t* offsets, int32_t n,
                                int32_t* out) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    for (int32_t i = 0; i < n; ++i) {
        out[i] = t->get_or_create(data + offsets[i],
                                  offsets[i + 1] - offsets[i],
                                  /*create=*/true, /*pin=*/false,
                                  /*touch_on_hit=*/true);
    }
    return n;
}

// ---- param-key extensions (hot-key table: composite keys, counted row
// pins, created flags — the ParamKeyRegistry analog; see
// rules/param_flow.py NativeParamKeyRegistry for the key encodings) ----

// batch get_or_create with created flags (concatenated keys like
// str_get_or_create_batch).
int32_t str_get_or_create_batch2(void* h, const char* data,
                                 const int32_t* offsets, int32_t n,
                                 int32_t* out, uint8_t* created) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    for (int32_t i = 0; i < n; ++i) {
        out[i] = t->get_or_create2(data + offsets[i],
                                   offsets[i + 1] - offsets[i],
                                   created + i);
    }
    return n;
}

// int-key fast path: each packed key is slot * 2^32 + (value + 2^31)
// (the vector resolution path's combine-key). The canonical key bytes
// [slot le4]['i'][value le8] are produced HERE, so Python never encodes
// per-key — one FFI call per batch of distinct keys.
int32_t i64_get_or_create_batch(void* h, const int64_t* packed, int32_t n,
                                int32_t* out, uint8_t* created) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    char key[13];
    for (int32_t i = 0; i < n; ++i) {
        int64_t p = packed[i];
        int32_t slot = (int32_t)(p >> 32);
        int64_t value = (int64_t)(p & 0xffffffffll) - (1ll << 31);
        // Explicit little-endian byte writes: Python's string-path
        // encoder pins '<i'/'<q', so a host-endian memcpy on a
        // big-endian machine would intern the same logical key twice.
        uint32_t us = (uint32_t)slot;
        uint64_t uv = (uint64_t)value;
        for (int b = 0; b < 4; ++b) key[b] = (char)((us >> (8 * b)) & 0xff);
        key[4] = 'i';
        for (int b = 0; b < 8; ++b)
            key[5 + b] = (char)((uv >> (8 * b)) & 0xff);
        out[i] = t->get_or_create2(key, 13, created + i);
    }
    return n;
}

// total live counted row pins (observability / test introspection)
int64_t str_pin_total(void* h) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    int64_t n = 0;
    for (const auto& e : t->slots) n += e.pin_count;
    return n;
}

// counted row pins: one increment/decrement per occurrence in rows[]
// (duplicates intended — the caller passes raw in-flight pair rows).
void str_pin_rows(void* h, const int32_t* rows, int32_t n) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    for (int32_t i = 0; i < n; ++i) {
        int32_t r = rows[i];
        if (r >= 0 && r < t->capacity) ++t->slots[r].pin_count;
    }
}

void str_unpin_rows(void* h, const int32_t* rows, int32_t n) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    for (int32_t i = 0; i < n; ++i) {
        int32_t r = rows[i];
        if (r >= 0 && r < t->capacity && t->slots[r].pin_count > 0)
            --t->slots[r].pin_count;
    }
}

// iterate live (name, id) pairs: copies ids of live slots into out_ids,
// returns live count (names retrievable via str_name_of).
int32_t str_live_ids(void* h, int32_t* out_ids, int32_t cap) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    int32_t n = 0;
    // LRU order (oldest first) to mirror the Python OrderedDict iteration
    for (int32_t i = t->lru_head; i >= 0 && n < cap; i = t->slots[i].next)
        out_ids[n++] = t->slots[i].id;
    return n;
}

// Atomic (id, name) snapshot under ONE lock acquisition (items() must not
// pair ids with names across eviction windows). Writes up to `cap` live
// entries in LRU order (oldest first): ids[i], lens[i], names concatenated
// into buf. Returns the live count, or -(bytes needed) when buf is too
// small (caller retries with a bigger buffer).
int32_t str_snapshot(void* h, int32_t* ids, int32_t* lens, int32_t cap,
                     char* buf, int32_t buflen) {
    Table* t = static_cast<Table*>(h);
    std::lock_guard<std::mutex> g(t->mu);
    int64_t need = 0;
    for (int32_t i = t->lru_head; i >= 0; i = t->slots[i].next)
        need += t->slots[i].len;
    if (need > buflen) return (int32_t)-need;
    int32_t n = 0;
    int32_t off = 0;
    for (int32_t i = t->lru_head; i >= 0 && n < cap; i = t->slots[i].next) {
        const Entry& e = t->slots[i];
        ids[n] = e.id;
        lens[n] = e.len;
        std::memcpy(buf + off, e.name, e.len);
        off += e.len;
        ++n;
    }
    return n;
}

}  // extern "C"
