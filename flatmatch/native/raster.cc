// Native host-side raster kernels for the scene compiler.
//
// The renderer's C++ runtime layer: the reference implements its
// host raster pipeline in C99 (/root/reference/image.c: BFS distance
// transform :88-142, flood fill :144-179; parseLayout.c: dilation :571-594,
// RLE collision encoding :538-569). These are the scene compiler's hot
// loops; this library re-implements them with the same semantics for the
// Python layer to call through ctypes (flatmatch/native/__init__.py),
// with the NumPy/SciPy implementations kept as a portable fallback.
//
// Build: g++ -O3 -shared -fPIC raster.cc -o libflatmatch_raster.so

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// BFS distance transform (8-neighbor / Chebyshev).
// seeds: uint8 [h*w] nonzero = seed. out: int32 [h*w] gets 1 at seeds and
// 1 + chebyshev distance elsewhere (matching image.c:88-142's in-place
// semantics). Returns the maximum assigned value, 0 if no seeds.
int32_t fm_distance_transform(const uint8_t* seeds, int32_t h, int32_t w,
                              int32_t* out) {
    const int64_t n = (int64_t)h * w;
    std::vector<int64_t> frontier;
    frontier.reserve(n / 4 + 1);
    for (int64_t i = 0; i < n; i++) {
        out[i] = seeds[i] ? 1 : 0;
        if (seeds[i]) frontier.push_back(i);
    }
    if (frontier.empty()) {
        std::memset(out, 0, n * sizeof(int32_t));
        return 0;
    }
    int32_t dist = 1;
    std::vector<int64_t> next;
    next.reserve(frontier.size());
    while (!frontier.empty()) {
        next.clear();
        const int32_t nd = dist + 1;
        for (int64_t idx : frontier) {
            const int32_t y = (int32_t)(idx / w), x = (int32_t)(idx % w);
            const int32_t y0 = y > 0 ? y - 1 : 0, y1 = y < h - 1 ? y + 1 : h - 1;
            const int32_t x0 = x > 0 ? x - 1 : 0, x1 = x < w - 1 ? x + 1 : w - 1;
            for (int32_t yy = y0; yy <= y1; yy++)
                for (int32_t xx = x0; xx <= x1; xx++) {
                    const int64_t j = (int64_t)yy * w + xx;
                    if (out[j] == 0) {
                        out[j] = nd;
                        next.push_back(j);
                    }
                }
        }
        frontier.swap(next);
        if (!frontier.empty()) dist = nd;
    }
    return dist;
}

// 8-connected flood fill in place over uint32 pixels (image.c:144-179).
void fm_flood_fill(uint32_t* img, int32_t h, int32_t w, int32_t x, int32_t y,
                   uint32_t value, uint32_t background) {
    if (x < 0 || x >= w || y < 0 || y >= h) return;
    if (img[(int64_t)y * w + x] != background || value == background) return;
    std::vector<int64_t> stack;
    stack.push_back((int64_t)y * w + x);
    img[(int64_t)y * w + x] = value;
    while (!stack.empty()) {
        const int64_t idx = stack.back();
        stack.pop_back();
        const int32_t cy = (int32_t)(idx / w), cx = (int32_t)(idx % w);
        const int32_t y0 = cy > 0 ? cy - 1 : 0, y1 = cy < h - 1 ? cy + 1 : h - 1;
        const int32_t x0 = cx > 0 ? cx - 1 : 0, x1 = cx < w - 1 ? cx + 1 : w - 1;
        for (int32_t yy = y0; yy <= y1; yy++)
            for (int32_t xx = x0; xx <= x1; xx++) {
                const int64_t j = (int64_t)yy * w + xx;
                if (img[j] == background) {
                    img[j] = value;
                    stack.push_back(j);
                }
            }
    }
}

// Chebyshev (square-kernel) boolean dilation by `radius` pixels
// (parseLayout.c:571-594). in/out: uint8 [h*w]. Decomposed into a
// horizontal then vertical running pass: O(h*w*radius) worst case but
// branch-cheap; radius is 5 in production.
void fm_dilate(const uint8_t* in, int32_t h, int32_t w, int32_t radius,
               uint8_t* out) {
    std::vector<uint8_t> tmp((size_t)h * w, 0);
    for (int32_t y = 0; y < h; y++) {
        const uint8_t* row = in + (int64_t)y * w;
        uint8_t* trow = tmp.data() + (int64_t)y * w;
        for (int32_t x = 0; x < w; x++) {
            uint8_t v = 0;
            const int32_t x0 = x - radius > 0 ? x - radius : 0;
            const int32_t x1 = x + radius < w - 1 ? x + radius : w - 1;
            for (int32_t xx = x0; xx <= x1 && !v; xx++) v = row[xx];
            trow[x] = v;
        }
    }
    for (int32_t x = 0; x < w; x++)
        for (int32_t y = 0; y < h; y++) {
            uint8_t v = 0;
            const int32_t y0 = y - radius > 0 ? y - radius : 0;
            const int32_t y1 = y + radius < h - 1 ? y + radius : h - 1;
            for (int32_t yy = y0; yy <= y1 && !v; yy++)
                v = tmp[(int64_t)yy * w + x];
            out[(int64_t)y * w + x] = v;
        }
}

// Run-length encode a boolean raster in row-major order, first run counting
// `first` values (parseLayout.c:538-569: first run impassable). Returns the
// number of runs written to `runs` (caller provides h*w+1 capacity).
int64_t fm_rle(const uint8_t* mask, int64_t n, uint8_t first, int64_t* runs) {
    int64_t nruns = 0;
    uint8_t cur = first;
    int64_t count = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t v = mask[i] ? 1 : 0;
        if (v == cur) {
            count++;
        } else {
            runs[nruns++] = count;
            cur = v;
            count = 1;
        }
    }
    runs[nruns++] = count;
    return nruns;
}

// Greedy maximal-run rectangle decomposition (parseLayout.c:425-491's scan
// order): repeatedly take the next non-invalidated pixel in row-major order,
// extend right while the color matches, then extend down while the whole row
// span matches, invalidate, and emit (x0, y0, x1, y1, color).
// Returns the number of rectangles written; `rects` needs 5*h*w capacity.
int64_t fm_decompose(uint32_t* img, int32_t h, int32_t w, uint32_t invalid,
                     int64_t* rects) {
    int64_t nr = 0;
    for (int32_t y = 0; y < h; y++) {
        for (int32_t x = 0; x < w; x++) {
            const uint32_t color = img[(int64_t)y * w + x];
            if (color == invalid) continue;
            int32_t x_end = x;
            while (x_end + 1 < w && img[(int64_t)y * w + x_end + 1] == color)
                x_end++;
            int32_t y_end = y + 1;
            for (; y_end < h; y_end++) {
                bool all = true;
                for (int32_t xx = x; xx <= x_end && all; xx++)
                    all = img[(int64_t)y_end * w + xx] == color;
                if (!all) break;
            }
            y_end--;
            for (int32_t yy = y; yy <= y_end; yy++)
                for (int32_t xx = x; xx <= x_end; xx++)
                    img[(int64_t)yy * w + xx] = invalid;
            rects[nr * 5 + 0] = x;
            rects[nr * 5 + 1] = y;
            rects[nr * 5 + 2] = x_end + 1;
            rects[nr * 5 + 3] = y_end + 1;
            rects[nr * 5 + 4] = color;
            nr++;
            x = x_end;  // skip past the claimed span (loop x++ advances one)
        }
    }
    return nr;
}

}  // extern "C"
