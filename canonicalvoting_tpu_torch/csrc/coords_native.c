/* Native coordinate manager: hashed voxel lookups for kernel-map building.
 *
 * The port's copy of the JAX package's native/coords_native.c (the C
 * counterpart of MinkowskiEngine's CoordinateManager): gather-form neighbor
 * tables and stride-2 coordinate downsamples for ops/coords.py, built with
 * cc into build/ on first use (ops/cuda_build.py) and bound with ctypes.
 * An open-addressing hash over the input rows replaces the NumPy path's
 * sorted searches (one per kernel offset); both give the same arrays.
 *
 * Key layout matches ops/coords.pack_coords: batch | x+2^17 | y+2^17 | z+2^17
 * packed into 18-bit fields of a uint64.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define AXIS_BITS 18
#define AXIS_OFF (1 << (AXIS_BITS - 1))

static inline uint64_t pack4(const int32_t *c) {
    uint64_t b = (uint64_t)(uint32_t)c[0];
    uint64_t x = (uint64_t)(c[1] + AXIS_OFF);
    uint64_t y = (uint64_t)(c[2] + AXIS_OFF);
    uint64_t z = (uint64_t)(c[3] + AXIS_OFF);
    return (((b << AXIS_BITS | x) << AXIS_BITS | y) << AXIS_BITS) | z;
}

static inline uint64_t hash64(uint64_t k) {
    /* splitmix64 finalizer */
    k += 0x9e3779b97f4a7c15ULL;
    k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ULL;
    k = (k ^ (k >> 27)) * 0x94d049bb133111ebULL;
    return k ^ (k >> 31);
}

typedef struct {
    uint64_t *keys;
    int32_t *vals;
    uint64_t mask;
} Table;

static int table_init(Table *t, int64_t n) {
    uint64_t cap = 16;
    while (cap < (uint64_t)(n * 2 + 4)) cap <<= 1;
    t->keys = (uint64_t *)malloc(cap * sizeof(uint64_t));
    t->vals = (int32_t *)malloc(cap * sizeof(int32_t));
    if (!t->keys || !t->vals) return -1;
    memset(t->keys, 0xff, cap * sizeof(uint64_t)); /* EMPTY = all ones */
    t->mask = cap - 1;
    return 0;
}

#define EMPTY 0xffffffffffffffffULL

static inline void table_put(Table *t, uint64_t key, int32_t val) {
    uint64_t i = hash64(key) & t->mask;
    while (t->keys[i] != EMPTY) {
        if (t->keys[i] == key) { return; } /* keep first */
        i = (i + 1) & t->mask;
    }
    t->keys[i] = key;
    t->vals[i] = val;
}

static inline int32_t table_get(const Table *t, uint64_t key) {
    uint64_t i = hash64(key) & t->mask;
    while (t->keys[i] != EMPTY) {
        if (t->keys[i] == key) return t->vals[i];
        i = (i + 1) & t->mask;
    }
    return -1;
}

/* Gather-form neighbor table: nbr[m*k + j] = index of in_coords row whose
 * coordinate equals out_coords[m] + offsets[j] (batch preserved), else -1.
 * Rows >= n_out_valid are left as -1 (caller pre-fills). */
int build_nbr_table_native(
    const int32_t *in_coords, int64_t n_in_valid,
    const int32_t *out_coords, int64_t n_out_valid,
    const int32_t *offsets, int64_t k,
    int32_t *nbr /* (n_out_total, k), pre-filled with -1 */,
    int64_t n_out_total)
{
    Table t;
    if (table_init(&t, n_in_valid) != 0) return -1;
    for (int64_t i = 0; i < n_in_valid; i++) {
        table_put(&t, pack4(in_coords + 4 * i), (int32_t)i);
    }
    for (int64_t m = 0; m < n_out_valid; m++) {
        const int32_t *c = out_coords + 4 * m;
        int32_t q[4];
        q[0] = c[0];
        for (int64_t j = 0; j < k; j++) {
            q[1] = c[1] + offsets[3 * j];
            q[2] = c[2] + offsets[3 * j + 1];
            q[3] = c[3] + offsets[3 * j + 2];
            nbr[m * k + j] = table_get(&t, pack4(q));
        }
    }
    free(t.keys);
    free(t.vals);
    (void)n_out_total;
    return 0;
}

/* Unique floor-stride downsample, preserving batch; returns count. Output
 * rows are in FIRST-OCCURRENCE order; caller may sort by key afterwards. */
int64_t downsample_coords_native(
    const int32_t *coords, int64_t n, int32_t stride,
    int32_t *out /* (n, 4) capacity */)
{
    Table t;
    if (table_init(&t, n) != 0) return -1;
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        const int32_t *c = coords + 4 * i;
        int32_t d[4];
        d[0] = c[0];
        /* floor division for negatives */
        for (int a = 1; a < 4; a++) {
            int32_t v = c[a];
            int32_t q = v / stride;
            if ((v % stride) != 0 && ((v < 0) != (stride < 0))) q -= 1;
            d[a] = q * stride;
        }
        uint64_t key = pack4(d);
        if (table_get(&t, key) < 0) {
            table_put(&t, key, (int32_t)m);
            memcpy(out + 4 * m, d, 4 * sizeof(int32_t));
            m++;
        }
    }
    free(t.keys);
    free(t.vals);
    return m;
}
