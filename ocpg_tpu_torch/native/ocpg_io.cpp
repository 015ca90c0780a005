// ocpg_io — native (C++) decode library of the ocpg_tpu_torch data path, a
// copy of ocpg_tpu/native/ocpg_io.cpp.
//
// The reference framework's data loader leans on torch DataLoader worker
// *processes* for decode throughput (four workers); the port uses a
// thread-pool loader (data/loader.py), so decode work must release the GIL
// and run at native speed.  PIL does both, but routes every frame through
// Python object plumbing and always decodes JPEGs at full resolution.  This
// library gives the loader a direct libjpeg/libpng path:
//
//   * ocpg_decode_jpeg   — baseline/progressive JPEG -> RGB8 HWC, with
//                          libjpeg's DCT-domain prescale (denom 1/2/4/8:
//                          decode at 8/denom-ths of full size for ~denom^2
//                          less IDCT + colorspace work).  Prescale is opt-in
//                          at the Python layer: full-size decode is the
//                          default so training data is bit-comparable with
//                          the PIL path.
//   * ocpg_decode_png    — PNG -> palette indices (DAVIS/YTVOS annotation
//                          masks ARE their palette indices: object ids), or
//                          gray8, or RGB8, reported via *channels.
//   * ocpg_rle_encode / ocpg_rle_decode — the COCO run-length codec.
//
// Every entry point is a plain C function operating on caller-owned buffers
// (two-call protocol: *_info for dimensions, then decode into a numpy array
// allocated by the Python side) — no allocation crosses the boundary, so the
// ctypes bindings in native/io.py stay trivial and the GIL is released for
// the whole decode (ctypes drops it around foreign calls).
//
// Build: see native/io.py (g++ -O2 -shared -fPIC ... -ljpeg -lpng, compiled
// at first use into ocpg_tpu_torch/_build/, keyed by a hash of this source).

#include <csetjmp>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>
#include <png.h>

namespace {

// libjpeg's default error handler calls exit(); trampoline back instead.
struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

void jpeg_silent(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Return codes (shared by all entry points)
//   0 ok; -1 bad/corrupt stream; -2 output buffer too small; -3 bad args
enum { OCPG_OK = 0, OCPG_EBAD = -1, OCPG_ESIZE = -2, OCPG_EARG = -3 };

// Dimensions of the decode that *would* happen at `denom` (1, 2, 4 or 8):
// libjpeg rounds the scaled size up, so the Python side must size its
// buffer with this call, not with ceil-division of the full size.
int ocpg_jpeg_info(const unsigned char* buf, unsigned long len, int denom,
                   int* h, int* w) {
    if (!buf || !h || !w || (denom != 1 && denom != 2 && denom != 4 && denom != 8))
        return OCPG_EARG;
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_err_exit;
    err.mgr.emit_message = jpeg_silent;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return OCPG_EBAD;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return OCPG_EBAD;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
    cinfo.out_color_space = JCS_RGB;
    jpeg_calc_output_dimensions(&cinfo);
    *h = static_cast<int>(cinfo.output_height);
    *w = static_cast<int>(cinfo.output_width);
    jpeg_destroy_decompress(&cinfo);
    return OCPG_OK;
}

// Decode to RGB8 HWC into `out` (capacity `cap` bytes).  On success *out_h /
// *out_w hold the decoded size (== ocpg_jpeg_info at the same denom).
int ocpg_decode_jpeg(const unsigned char* buf, unsigned long len, int denom,
                     unsigned char* out, unsigned long cap,
                     int* out_h, int* out_w) {
    if (!buf || !out || !out_h || !out_w ||
        (denom != 1 && denom != 2 && denom != 4 && denom != 8))
        return OCPG_EARG;
    jpeg_decompress_struct cinfo;
    JpegErr err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_err_exit;
    err.mgr.emit_message = jpeg_silent;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return OCPG_EBAD;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf), len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return OCPG_EBAD;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
    cinfo.out_color_space = JCS_RGB;   // libjpeg converts gray/YCbCr for us
    jpeg_start_decompress(&cinfo);
    const unsigned long row = 3ul * cinfo.output_width;
    if (row * cinfo.output_height > cap) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return OCPG_ESIZE;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW rows[1] = {out + row * cinfo.output_scanline};
        jpeg_read_scanlines(&cinfo, rows, 1);
    }
    *out_h = static_cast<int>(cinfo.output_height);
    *out_w = static_cast<int>(cinfo.output_width);
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return OCPG_OK;
}

namespace {

struct PngReadState {
    const unsigned char* buf;
    png_size_t len;
    png_size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
    PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
    if (s->pos + n > s->len) {
        png_error(png, "read past end");
        return;
    }
    std::memcpy(out, s->buf + s->pos, n);
    s->pos += n;
}

void png_silent_warn(png_structp, png_const_charp) {}

// Shared open/validate; on success the struct pointers are live and info read.
int png_open(const unsigned char* buf, unsigned long len, PngReadState* state,
             png_structp* png_out, png_infop* info_out) {
    if (!buf || len < 8 || png_sig_cmp(buf, 0, 8))
        return OCPG_EBAD;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, png_silent_warn);
    if (!png) return OCPG_EBAD;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return OCPG_EBAD;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return OCPG_EBAD;
    }
    state->buf = buf;
    state->len = len;
    state->pos = 0;
    png_set_read_fn(png, state, png_mem_read);
    png_read_info(png, info);
    *png_out = png;
    *info_out = info;
    return OCPG_OK;
}

// Decide the output channel count for a PNG: 1 for palette (indices) and
// gray, 3 otherwise (alpha stripped, 16-bit narrowed).
int png_out_channels(png_structp png, png_infop info) {
    switch (png_get_color_type(png, info)) {
        case PNG_COLOR_TYPE_PALETTE:
        case PNG_COLOR_TYPE_GRAY:
        case PNG_COLOR_TYPE_GRAY_ALPHA:
            return 1;
        default:
            return 3;
    }
}

}  // namespace

int ocpg_png_info(const unsigned char* buf, unsigned long len,
                  int* h, int* w, int* channels) {
    if (!h || !w || !channels) return OCPG_EARG;
    PngReadState state;
    png_structp png;
    png_infop info;
    int rc = png_open(buf, len, &state, &png, &info);
    if (rc != OCPG_OK) return rc;
    *h = static_cast<int>(png_get_image_height(png, info));
    *w = static_cast<int>(png_get_image_width(png, info));
    *channels = png_out_channels(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    return OCPG_OK;
}

// 1 if the PNG is palette-coded, 0 if not, OCPG_EBAD on a bad stream.
// Callers that want RGB must distinguish: a palette decode yields indices
// that only mean colors through the palette table (ocpg_decode_png never
// applies it), whereas a gray decode yields intensity directly.
int ocpg_png_is_palette(const unsigned char* buf, unsigned long len) {
    PngReadState state;
    png_structp png;
    png_infop info;
    int rc = png_open(buf, len, &state, &png, &info);
    if (rc != OCPG_OK) return rc;
    const int pal = png_get_color_type(png, info) == PNG_COLOR_TYPE_PALETTE;
    png_destroy_read_struct(&png, &info, nullptr);
    return pal;
}

// Decode into `out` (capacity `cap`).  Palette images yield their palette
// INDICES (1 channel, uint8) — the representation DAVIS/YTVOS annotation
// readers need (object id per pixel, datasets.py).  Gray (incl. gray+alpha,
// 16-bit) yields gray8; everything else yields RGB8.
int ocpg_decode_png(const unsigned char* buf, unsigned long len,
                    unsigned char* out, unsigned long cap,
                    int* out_h, int* out_w, int* out_channels) {
    if (!out || !out_h || !out_w || !out_channels) return OCPG_EARG;
    PngReadState state;
    png_structp png;
    png_infop info;
    int rc = png_open(buf, len, &state, &png, &info);
    if (rc != OCPG_OK) return rc;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return OCPG_EBAD;
    }
    const int color = png_get_color_type(png, info);
    const int channels = png_out_channels(png, info);
    if (color == PNG_COLOR_TYPE_PALETTE) {
        png_set_packing(png);              // <8-bit indices -> one per byte
    } else {
        if (png_get_bit_depth(png, info) == 16) png_set_strip_16(png);
        png_set_strip_alpha(png);
        if (png_get_bit_depth(png, info) < 8) png_set_expand_gray_1_2_4_to_8(png);
    }
    png_read_update_info(png, info);
    const png_size_t rowbytes = png_get_rowbytes(png, info);
    const png_uint_32 h = png_get_image_height(png, info);
    const png_uint_32 w = png_get_image_width(png, info);
    if (rowbytes != static_cast<png_size_t>(w) * channels ||
        rowbytes * h > cap) {
        png_destroy_read_struct(&png, &info, nullptr);
        return OCPG_ESIZE;
    }
    // libpng wants a row-pointer table; interlaced files need all rows live,
    // and out is exactly that.
    for (png_uint_32 pass = 0,
                     npass = png_set_interlace_handling(png);
         pass < npass; ++pass) {
        for (png_uint_32 y = 0; y < h; ++y) {
            png_read_row(png, out + rowbytes * y, nullptr);
        }
    }
    png_read_end(png, nullptr);
    *out_h = static_cast<int>(h);
    *out_w = static_cast<int>(w);
    *out_channels = channels;
    png_destroy_read_struct(&png, &info, nullptr);
    return OCPG_OK;
}

// ---------------------------------------------------------------------------
// COCO run-length codec — the native role pycocotools' C mask.c plays in the
// reference eval/postprocess path (its postprocessors and A2D evaluation).
// Column-major (Fortran) runs starting with zeros,
// compressed with COCO's modified LEB128 (5 payload bits + continuation bit,
// ASCII offset 48, runs delta-coded against counts[i-2] from the 3rd element)
// — byte-identical to ocpg_tpu/evaluation/rle.py's pure-Python codec, the
// test oracle.
// ---------------------------------------------------------------------------

// Encode an F-order-flattened uint8 mask (i.e. the caller passes the pixels
// already in column-major order — numpy's transpose copy is faster than a
// strided column walk here, cache-line-hostile at DAVIS widths).  Writes the
// compressed string into `out` (cap bytes) and its length into *out_len.
// Returns OCPG_ESIZE if cap is too small (callers size with 7*n + 16:
// <= n+1 runs, <= 7 LEB128 chars per delta-coded run).
int ocpg_rle_encode(const unsigned char* flat, long n,
                    char* out, long cap, long* out_len) {
    if (!flat || !out || !out_len || n <= 0) return OCPG_EARG;
    long long prev2 = 0, prev1 = 0;  // counts[i-2], counts[i-1]
    long p = 0, i = 0;               // output cursor, run index
    unsigned char val = 0;           // runs alternate starting from 0
    long pix = 0;
    while (pix <= n) {
        // find the end of the current run of `val` pixels, a word at a time
        // (real masks are long-run; the byte loop alone loses to numpy's
        // vectorized diff on smooth masks)
        long start = pix;
        if (val) {
            while (pix + 8 <= n) {
                unsigned long long wv;
                std::memcpy(&wv, flat + pix, 8);
                // stop at the first word containing a zero byte
                if (((wv - 0x0101010101010101ULL) & ~wv &
                     0x8080808080808080ULL) != 0) break;
                pix += 8;
            }
            while (pix < n && flat[pix] != 0) ++pix;
        } else {
            while (pix + 8 <= n) {
                unsigned long long wv;
                std::memcpy(&wv, flat + pix, 8);
                if (wv != 0) break;
                pix += 8;
            }
            while (pix < n && flat[pix] == 0) ++pix;
        }
        long run = pix - start;
        long long xx = (i > 2) ? (long long)run - prev2 : (long long)run;
        prev2 = prev1; prev1 = run;
        ++i;
        bool more = true;
        while (more) {
            char c = (char)(xx & 0x1f);
            xx >>= 5;  // arithmetic shift: sign-extends negatives
            more = (c & 0x10) ? (xx != -1) : (xx != 0);
            if (more) c |= 0x20;
            if (p >= cap) return OCPG_ESIZE;
            out[p++] = (char)(c + 48);
        }
        val ^= 1;
        if (pix == n) break;
    }
    *out_len = p;
    return OCPG_OK;
}

// Decode a compressed RLE string into an F-order-flattened uint8 buffer of
// n = h*w pixels (caller reshapes (w, h) and transposes — a free numpy
// view).  Returns OCPG_EBAD on a malformed stream or if the run lengths do
// not sum to n.
int ocpg_rle_decode(const char* s, long slen, long n, unsigned char* flat) {
    if (!s || !flat || n <= 0) return OCPG_EARG;
    long long prev2 = 0, prev1 = 0;
    long i = 0, idx = 0;             // run index, flat pixel cursor
    unsigned char val = 0;
    long si = 0;
    while (si < slen) {
        long long x = 0;
        int k = 0;
        bool more = true;
        char c = 0;
        while (more) {
            if (si >= slen) return OCPG_EBAD;
            c = (char)(s[si++] - 48);
            x |= (long long)(c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++k;
        }
        if (c & 0x10) x |= -1LL << (5 * k);  // sign-extend
        if (i > 2) x += prev2;
        prev2 = prev1; prev1 = x;
        ++i;
        if (x < 0 || idx + x > n) return OCPG_EBAD;
        std::memset(flat + idx, val, (size_t)x);
        idx += (long)x;
        val ^= 1;
    }
    return idx == n ? OCPG_OK : OCPG_EBAD;
}

}  // extern "C"
