/* Undo the PNG row filters of an 8-bit grayscale image, one byte per pixel,
 * row by row in the order the PNG specification defines them (None, Sub, Up,
 * Average, Paeth). Host code: built with the host C compiler at first use
 * and called through ctypes by larvio_tpu_torch/data/png.py, which releases
 * the interpreter lock for the call. Average and Paeth rows need each
 * pixel's left neighbour's final value, a serial chain that numpy can only
 * walk one anti-diagonal at a time; here it is one pass over the bytes.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static inline int iabs(int v) { return v < 0 ? -v : v; }

/* rows: H x W filtered bytes; ftype: H filter types; out: H x W pixels.
 * Returns 0, or 1 + the index of the first row with an unknown filter. */
int larvio_png_unfilter(const uint8_t *rows, const uint8_t *ftype, int H, int W, uint8_t *out) {
    for (int r = 0; r < H; ++r) {
        const uint8_t *x = rows + (size_t)r * W;
        uint8_t *o = out + (size_t)r * W;
        const uint8_t *up = r ? o - W : NULL;
        switch (ftype[r]) {
        case 0:
            memcpy(o, x, (size_t)W);
            break;
        case 1:
            for (int c = 0; c < W; ++c) o[c] = (uint8_t)(x[c] + (c ? o[c - 1] : 0));
            break;
        case 2:
            for (int c = 0; c < W; ++c) o[c] = (uint8_t)(x[c] + (up ? up[c] : 0));
            break;
        case 3:
            for (int c = 0; c < W; ++c) {
                int a = c ? o[c - 1] : 0, b = up ? up[c] : 0;
                o[c] = (uint8_t)(x[c] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int c = 0; c < W; ++c) {
                int a = c ? o[c - 1] : 0, b = up ? up[c] : 0, ul = (up && c) ? up[c - 1] : 0;
                int pa = iabs(b - ul), pb = iabs(a - ul), pc = iabs(a + b - 2 * ul);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : ul);
                o[c] = (uint8_t)(x[c] + pred);
            }
            break;
        default:
            return r + 1;
        }
    }
    return 0;
}
