/* Native host kernels for draco_tpu.
 *
 * The device compute path lives in XLA; these are the host-bound
 * kernels that the reference implemented in OpenMP Cython
 * (draco/util/_fast_tools.pyx) and caput's median module, and that have no
 * efficient device formulation: order statistics over sliding windows.
 *
 * Built with: cc -O3 -fno-math-errno -fopenmp -shared -fPIC
 * Loaded via ctypes (see draco_tpu/native/__init__.py); every entry point
 * uses a plain C ABI.
 */

#include <stdlib.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef struct {
    double v;
    double w;
} pair_t;

static int pair_cmp(const void *a, const void *b)
{
    const double va = ((const pair_t *)a)->v;
    const double vb = ((const pair_t *)b)->v;
    return (va > vb) - (va < vb);
}

/* Weighted median ("split" convention) of n (value, weight) pairs held in
 * scratch.  Zero-total-weight rows return 0. */
static double wmedian_scratch(pair_t *scratch, long n)
{
    double tot = 0.0;
    long i;

    for (i = 0; i < n; i++)
        tot += scratch[i].w;
    if (tot <= 0.0)
        return 0.0;

    qsort(scratch, (size_t)n, sizeof(pair_t), pair_cmp);

    const double half = 0.5 * tot;
    double cum = 0.0;
    double lo = scratch[n - 1].v;
    double hi = scratch[n - 1].v;
    int have_lo = 0;

    for (i = 0; i < n; i++) {
        cum += scratch[i].w;
        if (!have_lo && cum >= half) {
            lo = scratch[i].v;
            have_lo = 1;
        }
        if (cum > half) {
            hi = scratch[i].v;
            break;
        }
    }
    return 0.5 * (lo + hi);
}

/* Batched weighted median along the last axis.
 * x, w: [nrow, n]; out: [nrow]. */
void weighted_median_f64(const double *x, const double *w, double *out,
                         long nrow, long n)
{
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        pair_t *scratch = (pair_t *)malloc((size_t)n * sizeof(pair_t));
        long r, i;

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (r = 0; r < nrow; r++) {
            long m = 0;
            for (i = 0; i < n; i++) {
                double wi = w[r * n + i];
                if (wi > 0.0) {
                    scratch[m].v = x[r * n + i];
                    scratch[m].w = wi;
                    m++;
                }
            }
            out[r] = wmedian_scratch(scratch, m);
        }
        free(scratch);
    }
}

/* 2D moving-window weighted median.
 * x, w: [n0, n1] (edge-padded values handled by the caller passing zero
 * weights outside? No: we clamp rows and zero-weight columns here).
 * out: [n0, n1]; window (s0, s1) must be odd.
 * Values outside the array carry zero weight (caput convention). */
void moving_weighted_median_f64(const double *x, const double *w, double *out,
                                long n0, long n1, long s0, long s1)
{
    const long p0 = s0 / 2;
    const long p1 = s1 / 2;

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        pair_t *scratch = (pair_t *)malloc((size_t)(s0 * s1) * sizeof(pair_t));
        long i, j, di, dj;

#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
        for (i = 0; i < n0; i++) {
            for (j = 0; j < n1; j++) {
                long m = 0;
                for (di = -p0; di <= p0; di++) {
                    long ii = i + di;
                    if (ii < 0 || ii >= n0)
                        continue;
                    long base = ii * n1;
                    long j_lo = j - p1 < 0 ? 0 : j - p1;
                    long j_hi = j + p1 >= n1 ? n1 - 1 : j + p1;
                    for (dj = j_lo; dj <= j_hi; dj++) {
                        double wi = w[base + dj];
                        if (wi > 0.0) {
                            scratch[m].v = x[base + dj];
                            scratch[m].w = wi;
                            m++;
                        }
                    }
                }
                out[i * n1 + j] = wmedian_scratch(scratch, m);
            }
        }
        free(scratch);
    }
}

/* Scale-invariant-rank helper is vectorised in numpy; the remaining
 * _fast_tools entry points (banded matmuls, redundancy, beamform, variance)
 * run as batched device kernels in draco_tpu.ops. */
