/* Device busy time over a window, from CUPTI's activity records.
 *
 * Records every kernel, copy and set that runs on the card between
 * db_start() and db_stop(), keeps each one's (start, end) in nanoseconds,
 * and returns the union of those intervals: the seconds in which some
 * operation ran. The records are handled in C on CUPTI's own thread, so
 * the window's Python thread only pays CUPTI's cost per launch.
 *
 * libcupti is opened by path at run time (db_open), the same library that
 * PyTorch's profiler uses, so no CUPTI header is needed: the few types and
 * enum values used are part of CUPTI's stable ABI. Kernel, memcpy and
 * memset records of every version keep `start` at byte 16 and `end` at
 * byte 24.
 */
#include <dlfcn.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { KIND_MEMCPY = 1, KIND_MEMSET = 2, KIND_CONCURRENT_KERNEL = 10 };
static const int KINDS[] = {KIND_CONCURRENT_KERNEL, KIND_MEMCPY, KIND_MEMSET};
#define N_KINDS 3
#define BUFFER_BYTES (8u << 20)

typedef void (*request_fn)(uint8_t **, size_t *, size_t *);
typedef void (*complete_fn)(void *, uint32_t, uint8_t *, size_t, size_t);

static int (*p_register)(request_fn, complete_fn);
static int (*p_enable)(int);
static int (*p_disable)(int);
static int (*p_flush)(uint32_t);
static int (*p_next)(uint8_t *, size_t, void **);
static int (*p_dropped)(void *, uint32_t, size_t *);

static pthread_mutex_t lock = PTHREAD_MUTEX_INITIALIZER;
static uint64_t *iv;            /* start, end pairs */
static size_t n_iv, cap_iv;
static uint64_t n_bad, n_dropped;
static uint64_t bad[8][3];      /* the first misread records: kind, start, end */
static int failed_alloc, registered;

static void on_request(uint8_t **buf, size_t *size, size_t *max_records) {
    *buf = (uint8_t *)aligned_alloc(8, BUFFER_BYTES);
    *size = *buf ? BUFFER_BYTES : 0;
    *max_records = 0;
}

static void on_complete(void *ctx, uint32_t stream, uint8_t *buf,
                        size_t size, size_t valid) {
    void *rec = NULL;
    size_t dropped = 0;
    (void)size;
    pthread_mutex_lock(&lock);
    while (valid && p_next(buf, valid, &rec) == 0) {
        uint32_t kind;
        uint64_t s, e;
        memcpy(&kind, rec, 4);
        if (kind != KIND_CONCURRENT_KERNEL && kind != KIND_MEMCPY &&
            kind != KIND_MEMSET)
            continue;
        memcpy(&s, (uint8_t *)rec + 16, 8);
        memcpy(&e, (uint8_t *)rec + 24, 8);
        if (e < s || e - s > 100000000000ull) {  /* over 100 s: misread */
            if (n_bad < 8) {
                bad[n_bad][0] = kind;
                bad[n_bad][1] = s;
                bad[n_bad][2] = e;
            }
            n_bad++;
            continue;
        }
        if (n_iv + 2 > cap_iv) {
            size_t cap = cap_iv ? 2 * cap_iv : (1u << 20);
            uint64_t *grown = (uint64_t *)realloc(iv, cap * sizeof *iv);
            if (!grown) {
                failed_alloc = 1;
                continue;
            }
            iv = grown;
            cap_iv = cap;
        }
        iv[n_iv++] = s;
        iv[n_iv++] = e;
    }
    if (p_dropped && p_dropped(ctx, stream, &dropped) == 0)
        n_dropped += dropped;
    pthread_mutex_unlock(&lock);
    free(buf);
}

/* 0 when every entry point was found in the library at `path`. */
int db_open(const char *path) {
    void *h = dlopen(path, RTLD_NOW | RTLD_GLOBAL);
    if (!h)
        return 1;
    *(void **)&p_register = dlsym(h, "cuptiActivityRegisterCallbacks");
    *(void **)&p_enable = dlsym(h, "cuptiActivityEnable");
    *(void **)&p_disable = dlsym(h, "cuptiActivityDisable");
    *(void **)&p_flush = dlsym(h, "cuptiActivityFlushAll");
    *(void **)&p_next = dlsym(h, "cuptiActivityGetNextRecord");
    *(void **)&p_dropped = dlsym(h, "cuptiActivityGetNumDroppedRecords");
    return !(p_register && p_enable && p_disable && p_flush && p_next);
}

/* Start recording; 0, or CUPTI's error code. */
int db_start(void) {
    int rc, k;
    pthread_mutex_lock(&lock);
    n_iv = 0;
    n_bad = n_dropped = 0;
    failed_alloc = 0;
    pthread_mutex_unlock(&lock);
    if (!registered) {
        rc = p_register(on_request, on_complete);
        if (rc)
            return rc;
        registered = 1;
    }
    for (k = 0; k < N_KINDS; k++)
        if ((rc = p_enable(KINDS[k])) != 0)
            return rc;
    return 0;
}

/* Stop recording and hand every buffer over; 0, or CUPTI's error code. */
int db_stop(void) {
    int rc = p_flush(1), k;
    for (k = 0; k < N_KINDS; k++)
        p_disable(KINDS[k]);
    if (!rc)
        rc = p_flush(1);
    return rc;
}

static int by_start(const void *a, const void *b) {
    uint64_t x = ((const uint64_t *)a)[0], y = ((const uint64_t *)b)[0];
    return (x > y) - (x < y);
}

/* The first misread records (kind, start, end), as many as `out` holds
 * (n of them); returns how many were copied. */
int db_misread(uint64_t *out, int n) {
    int i, k;
    pthread_mutex_lock(&lock);
    k = n_bad < (uint64_t)n ? (int)n_bad : n;
    if (k > 8)
        k = 8;
    for (i = 0; i < k; i++)
        memcpy(out + 3 * i, bad[i], sizeof bad[i]);
    pthread_mutex_unlock(&lock);
    return k;
}

/* Union of the recorded intervals in seconds. `info` gets the number of
 * operations, records misread, records dropped, and 1 if memory ran out. */
double db_busy_seconds(uint64_t *info) {
    uint64_t total = 0, cs = 0, ce = 0;
    size_t i, n;
    pthread_mutex_lock(&lock);
    n = n_iv / 2;
    qsort(iv, n, 2 * sizeof *iv, by_start);
    for (i = 0; i < n; i++) {
        uint64_t s = iv[2 * i], e = iv[2 * i + 1];
        if (i == 0 || s > ce) {
            total += ce - cs;
            cs = s;
            ce = e;
        } else if (e > ce) {
            ce = e;
        }
    }
    total += ce - cs;
    info[0] = n;
    info[1] = n_bad;
    info[2] = n_dropped;
    info[3] = (uint64_t)failed_alloc;
    pthread_mutex_unlock(&lock);
    return 1e-9 * (double)total;
}
