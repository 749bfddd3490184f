// Native host runtime for gpuseqalign_tpu_torch.
//
// Fresh implementations (not ports) of the host-side hot paths:
//   * djb2-xor hashing over int32 streams
//   * NW linear-gap dense DP fills in four evaluation orders
//     (row-major / anti-diagonal / tile-diagonal / tile-diagonal + OpenMP),
//     the framework's analogs of the reference's four CPU algorithms
//     (ref: src/nwalign_cpu1..4_*.cpp)
//   * the reference-exact linear-gap traceback walk with RLE transcript
//     (semantics of ref: src/nwtrace1_plain.cpp:29-128)
//
// Built by native/build.py:  g++ -O3 -fopenmp -shared -fPIC

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

uint32_t nw_djb2_i32(const int32_t* data, int64_t n, uint32_t seed)
{
    uint32_t h = seed;
    for (int64_t k = 0; k < n; k++)
    {
        h = (h * 33u) ^ (uint32_t)data[k];
    }
    return h;
}

static inline int32_t max3i(int32_t a, int32_t b, int32_t c)
{
    int32_t m = a > b ? a : b;
    return m > c ? m : c;
}

// One DP cell update; H is row-major (adjrows x adjcols).
static inline void cell_update(int32_t* H, int adjcols, const int32_t* subst,
                               int substsz, const int32_t* Y, const int32_t* X,
                               int32_t g, int i, int j)
{
    const int32_t* hprev = H + (int64_t)(i - 1) * adjcols;
    int32_t* hcur = H + (int64_t)i * adjcols;
    int32_t diag = hprev[j - 1] + subst[(int64_t)Y[i] * substsz + X[j]];
    hcur[j] = max3i(diag, hprev[j] + g, hcur[j - 1] + g);
}

static void fill_headers(int32_t* H, int adjrows, int adjcols, int32_t g)
{
    for (int j = 0; j < adjcols; j++)
    {
        H[j] = (int32_t)j * g;
    }
    for (int i = 0; i < adjrows; i++)
    {
        H[(int64_t)i * adjcols] = (int32_t)i * g;
    }
}

// order: 0=row, 1=diag, 2=diagrow (tiled), 3=mt_diagrow (tiled + OpenMP).
int nw_align_dense(const int32_t* subst, int substsz,
                   const int32_t* Y, int adjrows,
                   const int32_t* X, int adjcols,
                   int32_t g, int order, int blocksz, int32_t* H)
{
    if (adjrows < 1 || adjcols < 1 || substsz < 1)
    {
        return 1;
    }
    fill_headers(H, adjrows, adjcols, g);
    const int rows = adjrows - 1;
    const int cols = adjcols - 1;

    switch (order)
    {
    case 0: // row-major
    {
        for (int i = 1; i <= rows; i++)
        {
            const int32_t* hprev = H + (int64_t)(i - 1) * adjcols;
            int32_t* hcur = H + (int64_t)i * adjcols;
            const int32_t* srow = subst + (int64_t)Y[i] * substsz;
            int32_t left = hcur[0];
            for (int j = 1; j <= cols; j++)
            {
                int32_t v = max3i(hprev[j - 1] + srow[X[j]],
                                  hprev[j] + g, left + g);
                hcur[j] = v;
                left = v;
            }
        }
        break;
    }
    case 1: // anti-diagonal element order
    {
        for (int d = 0; d < rows + cols - 1; d++)
        {
            int tbeg = std::max(0, d - (cols - 1));
            int tend = std::min(d + 1, rows);
            for (int t = tbeg; t < tend; t++)
            {
                cell_update(H, adjcols, subst, substsz, Y, X, g,
                            1 + t, 1 + (d - t));
            }
        }
        break;
    }
    case 2: // tile-diagonal outer order, row-major inside tiles
    case 3: // same, tiles of a diagonal in parallel (wavefront barrier)
    {
        if (blocksz < 1)
        {
            return 2;
        }
        const int trows = (rows + blocksz - 1) / blocksz;
        const int tcols = (cols + blocksz - 1) / blocksz;
        for (int td = 0; td < trows + tcols - 1; td++)
        {
            int tbeg = std::max(0, td - (tcols - 1));
            int tend = std::min(td + 1, trows);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (order == 3)
#endif
            for (int tt = tbeg; tt < tend; tt++)
            {
                int ibeg = 1 + tt * blocksz;
                int jbeg = 1 + (td - tt) * blocksz;
                int iend = std::min(ibeg + blocksz, 1 + rows);
                int jend = std::min(jbeg + blocksz, 1 + cols);
                for (int i = ibeg; i < iend; i++)
                {
                    for (int j = jbeg; j < jend; j++)
                    {
                        cell_update(H, adjcols, subst, substsz, Y, X, g, i, j);
                    }
                }
            }
        }
        break;
    }
    default:
        return 3;
    }
    return 0;
}

// Reference-exact NW linear-gap traceback (no debug-cells mode).
// Writes the RLE transcript into buf; returns its length, or -1 on overflow.
// out_hash gets djb2 over the transcript characters.
int64_t nw_trace_linear(const int32_t* H, int adjrows, int adjcols,
                        const int32_t* Y, const int32_t* X,
                        char* buf, int64_t cap, uint32_t* out_hash)
{
    int i = adjrows - 1;
    int j = adjcols - 1;
    // Collect edits walking backwards, then emit runs reversed.
    std::vector<char> edits;
    edits.reserve(adjrows + adjcols);
    while (true)
    {
        bool has = false;
        int32_t mx = 0;
        int di = 0, dj = 0;
        char edit = 0;
        if (i > 0 && j > 0)
        {
            mx = H[(int64_t)(i - 1) * adjcols + (j - 1)];
            has = true;
            di = -1;
            dj = -1;
            edit = (X[j] == Y[i]) ? '=' : 'X';
        }
        if (i > 0 && (!has || mx < H[(int64_t)(i - 1) * adjcols + j]))
        {
            mx = H[(int64_t)(i - 1) * adjcols + j];
            has = true;
            di = -1;
            dj = 0;
            edit = 'I';
        }
        if (j > 0 && (!has || mx < H[(int64_t)i * adjcols + (j - 1)]))
        {
            has = true;
            di = 0;
            dj = -1;
            edit = 'D';
        }
        i += di;
        j += dj;
        if (edit != 0)
        {
            edits.push_back(edit);
        }
        if (di == 0 && dj == 0)
        {
            break;
        }
    }

    // Runs in path order (top-left to bottom-right) as "<count><edit>".
    int64_t len = 0;
    int64_t n = (int64_t)edits.size();
    int64_t k = n;
    while (k > 0)
    {
        char e = edits[k - 1];
        int64_t run = 0;
        while (k > 0 && edits[k - 1] == e)
        {
            run++;
            k--;
        }
        char tmp[24];
        int m = 0;
        while (run > 0)
        {
            tmp[m++] = (char)('0' + (run % 10));
            run /= 10;
        }
        if (len + m + 1 > cap)
        {
            return -1;
        }
        for (int t = m - 1; t >= 0; t--)
        {
            buf[len++] = tmp[t];
        }
        buf[len++] = e;
    }

    uint32_t h = 5381;
    for (int64_t t = 0; t < len; t++)
    {
        h = (h * 33u) ^ (uint32_t)(unsigned char)buf[t];
    }
    *out_hash = h;
    return len;
}

// Sparse score hash: rolling-row recompute of the full logical matrix with
// kernel-stored tile-header substitution, folding every row into djb2.
// Mirrors trace/sparse.py _recompute_rows + _stored_header_overlay
// bit-exactly (all int32; values stay near +-2^30 so no overflow).
//   kind: 0 = NW, 1 = SW;  gap: 0 = linear, 1 = affine
//   hrowmat: (Rt*C, tw+1) row-major or NULL; hcolmat: (Rt*C, th+1) or NULL
// Returns the hash (seed folded like the Python path's djb2_init).
uint32_t nw_hash_sparse(const int32_t* subst, int substsz,
                        const int32_t* Y, int adjrows,
                        const int32_t* X, int adjcols,
                        int32_t go, int32_t ge, int kind, int gap,
                        const int32_t* hrowmat, const int32_t* hcolmat,
                        int th, int tw, int Rt, int C, uint32_t seed)
{
    const int32_t NINF = -(1 << 30);
    const bool sw = kind == 1;
    const bool affine = gap == 1;
    const bool ovl = hrowmat && hcolmat && th >= 1 && tw >= 1 && Rt >= 1 &&
                     C >= 1;
    std::vector<int32_t> prev(adjcols), cur(adjcols);
    std::vector<int32_t> fprev, fcur, vrow;
    if (affine)
    {
        fprev.assign(adjcols, NINF);
        fcur.resize(adjcols);
        vrow.resize(adjcols);
    }

    auto overlay = [&](int i, int32_t* row) {
        if (!ovl)
        {
            return;
        }
        int it = i / th;
        int ie = i % th;
        if (it == Rt) // saturated last row (get_tile_and_elem_ij)
        {
            it -= 1;
            ie += th;
        }
        if (ie == 0 && i != adjrows - 1 && it < Rt)
        {
            // Full stored header row: each tile's first tw entries, then
            // the last tile's boundary element.
            const int64_t base = (int64_t)it * C * (tw + 1);
            int n = 0;
            for (int jt = 0; jt < C && n < adjcols; jt++)
            {
                const int32_t* hr = hrowmat + base + (int64_t)jt * (tw + 1);
                for (int e = 0; e < tw && n < adjcols; e++)
                {
                    row[n++] = hr[e];
                }
            }
            if (n < adjcols)
            {
                row[n] = hrowmat[base + (int64_t)(C - 1) * (tw + 1) + tw];
            }
        }
        else
        {
            // Stored header-column cells (last header column excluded).
            const int64_t base = (int64_t)it * C * (th + 1);
            for (int jt = 0; jt < C; jt++)
            {
                int64_t j = (int64_t)jt * tw;
                if (j < adjcols && j != adjcols - 1)
                {
                    row[j] = hcolmat[base + (int64_t)jt * (th + 1) + ie];
                }
            }
        }
    };

    // Row 0.
    if (sw)
    {
        std::fill(prev.begin(), prev.end(), 0);
    }
    else if (affine)
    {
        prev[0] = 0;
        for (int j = 1; j < adjcols; j++)
        {
            prev[j] = go + (int32_t)j * ge;
        }
    }
    else
    {
        for (int j = 0; j < adjcols; j++)
        {
            prev[j] = (int32_t)j * go;
        }
    }
    overlay(0, prev.data());
    uint32_t h = seed;
    for (int j = 0; j < adjcols; j++)
    {
        h = (h * 33u) ^ (uint32_t)prev[j];
    }

    for (int i = 1; i < adjrows; i++)
    {
        const int32_t* srow = subst + (int64_t)Y[i] * substsz;
        if (!affine)
        {
            // cand[j] = max(prev[j-1] + s, prev[j] + go); SW clamps cand,
            // THEN the left-gap chain runs, THEN the row clamps (matching
            // _recompute_rows' order exactly).
            cur[0] = sw ? 0 : (int32_t)i * go;
            for (int j = 1; j < adjcols; j++)
            {
                int32_t c = std::max(prev[j - 1] + srow[X[j]],
                                     prev[j] + go);
                if (sw && c < 0)
                {
                    c = 0;
                }
                cur[j] = std::max(c, cur[j - 1] + go);
            }
            if (sw)
            {
                for (int j = 0; j < adjcols; j++)
                {
                    cur[j] = std::max(cur[j], 0);
                }
            }
        }
        else
        {
            // frow[j] = max(fprev[j], prev[j] + go) + ge; frow[0] = -inf.
            fcur[0] = NINF;
            for (int j = 1; j < adjcols; j++)
            {
                fcur[j] = std::max(fprev[j], prev[j] + go) + ge;
            }
            const int32_t h0 = sw ? 0 : (int32_t)(go + (int32_t)i * ge);
            // vrow[j] = max(prev[j-1] + s, frow[j]) (SW clamped);
            // vrow[0] is the E-chain seed vfull[0].
            vrow[0] = sw ? 0 : h0;
            for (int j = 1; j < adjcols; j++)
            {
                int32_t v = std::max(prev[j - 1] + srow[X[j]], fcur[j]);
                if (sw && v < 0)
                {
                    v = 0;
                }
                vrow[j] = v;
            }
            // e[j] = max(e[j-1], vrow[j-1] + go) + ge (direct Gotoh form
            // of the Python cummax construction).
            cur[0] = sw ? 0 : h0;
            int32_t e = NINF;
            for (int j = 1; j < adjcols; j++)
            {
                int32_t cand = vrow[j - 1] + go;
                e = std::max(e, cand) + ge;
                int32_t n = std::max(vrow[j], e);
                if (sw && n < 0)
                {
                    n = 0;
                }
                cur[j] = n;
            }
            std::swap(fprev, fcur);
        }
        overlay(i, cur.data());
        for (int j = 0; j < adjcols; j++)
        {
            h = (h * 33u) ^ (uint32_t)cur[j];
        }
        std::swap(prev, cur);
    }
    return h;
}

} // extern "C"
