// Multithreaded TIFF reader with LZW decompression — the native host-side
// decode tier feeding the device pipelines.
//
// The reference decodes 16-bit LZW microscopy TIFFs through
// tifffile-with-PIL-fallback (src/INT/Fluor_INT.py:350-368), single-threaded
// per file.  Keeping the device fed end to end needs strip-parallel
// native decode: each TIFF strip is an independent LZW stream, so strips
// fan out across a thread pool.
//
// Scope: classic TIFF and BigTIFF (version 43), little/big endian,
// grayscale 8/16-bit; compression 1 (none), 5 (LZW, TIFF variant: 9->12
// bit codes with early change), 8/32946 (zlib deflate), or 32773
// (PackBits RLE); predictor 1 or 2 (horizontal differencing); strip AND
// tile layouts (tags 322-325); multi-page via the IFD chain.  This covers
// every file the reference toolkit produces or consumes (2048x1536 u16
// LZW minisblack) plus the layouts and compressions common in modern
// microscopy exports (OME-TIFF-style tiled/deflate, >4 GB BigTIFF
// stacks).
//
// C ABI (ctypes):
//   int ip_tiff_info(path, page, *height, *width, *bits_per_sample,
//                    *samples_per_pixel)           -> 0 ok / negative error
//   int ip_tiff_decode(path, page, out, out_bytes) -> 0 ok / negative error
//   int ip_tiff_decode_batch(paths, n, page, out, frame_bytes,
//                            height, width, bits, samples)
//       -> 0 ok / negative error; every file must match the given shape
//   const char* ip_tiff_error()                    -> last error string

#include <fcntl.h>
#include <sys/mman.h>
#include <zlib.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;

// Read-only view of a TIFF file.  mmap-backed when possible (zero-copy:
// the LZW source bytes stream straight out of the page cache, no fread
// copy and no vector zero-fill) with a heap fallback for filesystems that
// refuse mmap.  Non-copyable: the destructor owns the mapping.
struct Reader {
    const uint8_t* ptr = nullptr;
    size_t size = 0;
    bool big_endian = false;
    bool bigtiff = false;  // version 43: 8-byte offsets, 20-byte IFD entries

    Reader() = default;
    Reader(const Reader&) = delete;
    Reader& operator=(const Reader&) = delete;
    ~Reader() {
        if (map_base_) ::munmap(map_base_, map_len_);
    }

    void* map_base_ = nullptr;
    size_t map_len_ = 0;
    std::vector<uint8_t> heap_;  // fallback storage

    const uint8_t& operator[](size_t i) const { return ptr[i]; }

    uint16_t u16(size_t off) const {
        if (off + 2 > size) return 0;
        return big_endian ? (uint16_t)((ptr[off] << 8) | ptr[off + 1])
                          : (uint16_t)(ptr[off] | (ptr[off + 1] << 8));
    }
    uint32_t u32(size_t off) const {
        if (off + 4 > size) return 0;
        return big_endian
                   ? ((uint32_t)ptr[off] << 24) | ((uint32_t)ptr[off + 1] << 16) |
                         ((uint32_t)ptr[off + 2] << 8) | ptr[off + 3]
                   : (uint32_t)ptr[off] | ((uint32_t)ptr[off + 1] << 8) |
                         ((uint32_t)ptr[off + 2] << 16) | ((uint32_t)ptr[off + 3] << 24);
    }
    uint64_t u64(size_t off) const {
        if (off + 8 > size) return 0;
        uint64_t v = 0;
        for (int i = 0; i < 8; ++i)
            v |= (uint64_t)ptr[off + i] << (big_endian ? 8 * (7 - i) : 8 * i);
        return v;
    }
};

struct IFDEntry {
    uint16_t tag;
    uint16_t type;
    uint64_t count;
    uint64_t value_off;  // raw offset field (u32 classic, u64 BigTIFF)
};

struct TiffPage {
    uint32_t width = 0, height = 0;
    uint16_t bits = 0, samples = 1, compression = 1, predictor = 1;
    uint32_t rows_per_strip = 0xFFFFFFFF;
    uint16_t sample_format = 1;  // tag 339: 1 = uint, 3 = IEEE float
    // tiled layout (tags 322-325): when tile_width != 0 the offsets/counts
    // vectors hold TILE offsets/counts in row-major tile order
    uint32_t tile_width = 0, tile_height = 0;
    std::vector<uint64_t> strip_offsets, strip_counts;
};

size_t type_size(uint16_t t) {
    switch (t) {
        case 1: case 2: case 6: case 7: return 1;
        case 3: case 8: return 2;
        case 4: case 9: case 11: return 4;
        case 5: case 10: case 12: return 8;
        case 16: case 17: case 18: return 8;  // LONG8 / SLONG8 / IFD8
        default: return 0;
    }
}

// Read the n-th value of an entry as uint64.  Classic entries inline up to
// 4 value bytes at entry_off+8; BigTIFF entries inline up to 8 at
// entry_off+12.
uint64_t entry_value(const Reader& r, const IFDEntry& e, size_t entry_off,
                     uint64_t idx) {
    size_t sz = type_size(e.type);
    uint64_t total = sz * e.count;
    size_t inline_cap = r.bigtiff ? 8 : 4;
    size_t inline_at = r.bigtiff ? 12 : 8;
    uint64_t base;
    if (total <= inline_cap) base = entry_off + inline_at;
    else base = e.value_off;
    size_t off = (size_t)(base + idx * sz);
    if (sz == 2) return r.u16(off);
    if (sz == 4) return r.u32(off);
    if (sz == 8) return r.u64(off);
    if (sz == 1) return off < r.size ? r.ptr[off] : 0;
    return 0;
}

// Saturating u32 view for dimension-like tags: a 2^32+ value is not a
// frame this decoder can represent — map it to UINT32_MAX so the existing
// size/overflow checks reject it rather than silently truncating.
uint32_t entry_value_u32(const Reader& r, const IFDEntry& e,
                         size_t entry_off, uint64_t idx) {
    uint64_t v = entry_value(r, e, entry_off, idx);
    return v > UINT32_MAX ? UINT32_MAX : (uint32_t)v;
}

bool parse_page(const Reader& r, int page, TiffPage* out, std::string* err) {
    if (r.size < 8) { *err = "file too small"; return false; }
    // Classic: u16 entry count, 12-byte entries, u32 next-IFD pointer.
    // BigTIFF (version 43): u64 count, 20-byte entries, u64 pointer.
    const bool big = r.bigtiff;
    const size_t entry_sz = big ? 20 : 12;
    const size_t count_sz = big ? 8 : 2;
    uint64_t ifd_off = big ? r.u64(8) : r.u32(4);
    auto ifd_count = [&](uint64_t off) -> uint64_t {
        return big ? r.u64((size_t)off) : r.u16((size_t)off);
    };
    for (int p = 0; p < page; ++p) {
        uint64_t n = ifd_count(ifd_off);
        size_t next_at = (size_t)(ifd_off + count_sz + entry_sz * n);
        uint64_t next = big ? r.u64(next_at) : r.u32(next_at);
        if (next == 0) break;  // clamp to last page (PIL seek behavior)
        ifd_off = next;
    }
    uint64_t n = ifd_count(ifd_off);
    if (n == 0 || n > 0xFFFF) { *err = "empty IFD"; return false; }
    for (uint64_t i = 0; i < n; ++i) {
        size_t eo = (size_t)(ifd_off + count_sz + entry_sz * i);
        IFDEntry e{r.u16(eo), r.u16(eo + 2),
                   big ? r.u64(eo + 4) : r.u32(eo + 4),
                   big ? r.u64(eo + 12) : r.u32(eo + 8)};
        // structural bound: an out-of-line value array lives in the file,
        // so count*size can't exceed it — rejects crafted multi-GB counts
        // before the resize() below turns them into an allocation
        if (e.count > r.size / (type_size(e.type) ? type_size(e.type) : 1) + 8)
            continue;
        switch (e.tag) {
            case 256: out->width = entry_value_u32(r, e, eo, 0); break;
            case 257: out->height = entry_value_u32(r, e, eo, 0); break;
            case 258: out->bits = (uint16_t)entry_value(r, e, eo, 0); break;
            case 259: out->compression = (uint16_t)entry_value(r, e, eo, 0); break;
            case 277: out->samples = (uint16_t)entry_value(r, e, eo, 0); break;
            case 278: out->rows_per_strip = entry_value_u32(r, e, eo, 0); break;
            case 317: out->predictor = (uint16_t)entry_value(r, e, eo, 0); break;
            case 339: out->sample_format = (uint16_t)entry_value(r, e, eo, 0); break;
            case 273:
            case 324:  // TileOffsets share the offsets vector
                out->strip_offsets.resize(e.count);
                for (uint64_t k = 0; k < e.count; ++k)
                    out->strip_offsets[k] = entry_value(r, e, eo, k);
                break;
            case 279:
            case 325:  // TileByteCounts share the counts vector
                out->strip_counts.resize(e.count);
                for (uint64_t k = 0; k < e.count; ++k)
                    out->strip_counts[k] = entry_value(r, e, eo, k);
                break;
            case 322: out->tile_width = entry_value_u32(r, e, eo, 0); break;
            case 323: out->tile_height = entry_value_u32(r, e, eo, 0); break;
            default: break;
        }
    }
    if (!out->width || !out->height || out->strip_offsets.empty()) {
        *err = "missing required tags";
        return false;
    }
    if (out->bits == 0) out->bits = 1;
    if (out->rows_per_strip == 0) out->rows_per_strip = out->height;
    return true;
}

// TIFF-variant LZW decode (9..12-bit codes, early change).
//
// Strings are emitted by copying from the already-decoded OUTPUT history:
// every table code remembers where its string first appeared in dst, so
// emission is a forward copy (fixed 16-byte block copies for the common
// short strings; overlap-safe byte loop only when regions overlap)
// instead of a per-byte backward chain walk.
//
// Hot-loop design points (measured on the 2048x1536 u16 LZW corpus,
// ~3M codes/frame, ~17 cycles/code in the naive chain walk, ~12 in the
// packed-offset r3 design, ~9-10 in this one):
//  - the bit reader is ABSOLUTE-POSITION: each code comes from one
//    unaligned 64-bit load + bswap + shift at bit offset `bitpos`,
//    replacing the data-dependent refill branch of a shift-register
//    reader (taken every 2-3 codes, poorly predicted);
//  - the table stores SOURCE POINTERS, and the 256 literal slots point
//    permanently at a static identity byte array — literal and string
//    emission are ONE unconditional path (the r3 design's lazy literal
//    first-emission branch and its per-call 2 KB re-arm are gone, as is
//    the KwKwK select: code == next_code always hits the entry stored on
//    the line above, so tab[code] is correct unconditionally);
//  - lengths live in a separate u16 table rather than packed bits, so
//    emit-side extraction is two independent L1 loads with no unpack ALU.
//
// A stream is valid only if it fills dst exactly: a short stream means a
// truncated/corrupt strip and must fail (so callers surface it as a
// LoadError instead of reading uninitialized memory).
bool lzw_decode(const uint8_t* src, size_t src_len, uint8_t* dst,
                size_t dst_len, std::string* err) {
    constexpr int kClear = 256, kEoi = 257, kFirstFree = 258, kMaxCode = 4096;
    // Identity byte array backing literal emissions; padded to 256+16 so
    // the fixed 16-byte block copy may start at any literal value.
    static const struct Lit {
        uint8_t b[256 + 16];
        Lit() {
            for (int i = 0; i < 256 + 16; ++i) b[i] = (uint8_t)i;
        }
    } kLit;
    // Dynamic entries [kFirstFree, next_code) are NOT cleared between
    // strips: stale slots are unreachable because a code is only emitted
    // when code <= next_code and every live slot is (re)written at
    // creation earlier in the SAME call after the last Clear.  Literal
    // slots are written once at table creation and never change.  The
    // tables carry one extra dummy slot (kMaxCode) so entry creation can
    // store unconditionally: when the table is full, next_code parks at
    // kMaxCode and the store lands in the never-read spare slot instead
    // of costing a bounds branch per code.
    static thread_local std::vector<const uint8_t*> tab_ptr;
    static thread_local std::vector<uint16_t> tab_len;
    if (tab_ptr.size() != (size_t)kMaxCode + 1) {
        tab_ptr.assign(kMaxCode + 1, kLit.b);
        tab_len.assign(kMaxCode + 1, 1);
        for (int i = 0; i < 256; ++i) tab_ptr[i] = kLit.b + i;
    }
    const uint8_t** const tp = tab_ptr.data();
    uint16_t* const tl = tab_len.data();

    int next_code = kFirstFree, code_bits = 9;
    uint32_t code_mask = (1u << 9) - 1;
    size_t bitpos = 0;
    const size_t total_bits = src_len * 8;
    size_t di = 0;
    uint32_t prev_len = 0;  // 0 = no previous code (start / after Clear)
    // Fast emit is allowed while the write cursor stays >=16 bytes clear of
    // the end; the tail runs through the careful path.
    const size_t safe_end = dst_len >= 16 ? dst_len - 16 : 0;

    // Set inside step() when a bulk-mode careful emit leaves the write head
    // inside the tail region: the bulk loop must hand off to the checked
    // tail loop before decoding another code.
    bool tail_handoff = false;

    // Careful emit for the tail region: clips at dst_len.
    auto emit_careful = [&](const uint8_t* p, uint32_t l) {
        if (di + l > dst_len) l = (uint32_t)(dst_len - di);
        uint8_t* d = dst + di;
        if ((uintptr_t)(p + l) <= (uintptr_t)d) {
            std::memcpy(d, p, l);
        } else {  // overlapping (run-length-style) copy
            for (uint32_t i = 0; i < l; ++i) d[i] = p[i];
        }
        di += l;
    };

    // One decoded code: table update + emit.  Returns 0 to continue, 1 on
    // a clean stop (EoI or dst full), -1 on a corrupt stream.
    // `bulk` is a call-site constant (each call inlines and folds it): in
    // the bulk steady-state loop the outer boundary test already guarantees
    // room for two <=16-byte emits, so the fast path drops its dst-bound
    // compare and the per-code di >= dst_len stop test disappears.
    // Returns 0 = continue, 1 = clean stop (EoI / dst full), -1 = corrupt
    // stream, 2 (bulk only) = write head entered the tail region mid-pair —
    // the caller must LEAVE the bulk loop before the pair's second code,
    // whose unchecked 16-byte fast emit could otherwise cross dst_len.
    auto step = [&](int code, const bool bulk)
        __attribute__((always_inline)) -> int {
        if (__builtin_expect(code >= kClear && code <= kEoi, 0)) {
            if (code == kEoi) return 1;
            next_code = kFirstFree;  // kClear
            code_bits = 9;
            code_mask = (1u << 9) - 1;
            prev_len = 0;
            return 0;
        }
        if (__builtin_expect(prev_len == 0, 0)) {  // first code after restart
            if (code >= 256) { *err = "bad first LZW code"; return -1; }
            if (di < dst_len) dst[di] = (uint8_t)code;
            ++di;
            prev_len = 1;
        } else {
            int new_entry = next_code;
            if (__builtin_expect(code > new_entry, 0)) {
                *err = "bad LZW code";
                return -1;
            }
            // new entry = prev string + first char of current emission;
            // both live contiguously starting at prev string's last
            // emission, i.e. at (di - prev_len) once we emit at di.
            // Unconditional store: a full table parks next_code at
            // kMaxCode, the dummy slot.
            tp[new_entry] = dst + (di - prev_len);
            tl[new_entry] = (uint16_t)(prev_len + 1);
            // KwKwK (code == new_entry) needs no special case: the code
            // mask caps code at 4095 < kMaxCode, so the store above just
            // armed tab[code], and the overlap-safe paths below reproduce
            // the about-to-be-written byte correctly.
            const uint8_t* p = tp[code];
            uint32_t l = tl[code];
            if (__builtin_expect(
                    (bulk || di + l <= safe_end) && l <= 16 &&
                        (uintptr_t)(dst + di) - (uintptr_t)p >= 16, 1)) {
                // unified literal/string fast path: one fixed-size block
                // copy.  The UNSIGNED difference test makes the path
                // layout-independent: history pointers always sit below
                // dst+di so it reads "source ends >=16 before dest"
                // (overlap-free block copy), while literal pointers into
                // the static identity array wrap around to a huge value
                // and always qualify — the identity array is padded for a
                // 16-byte read and can never overlap a heap dst.
                std::memcpy(dst + di, p, 16);
                di += l;
            } else if (di + l <= safe_end) {  // long or overlapping string
                uint8_t* d = dst + di;
                if ((uintptr_t)(p + l) <= (uintptr_t)d) {
                    std::memcpy(d, p, l);
                } else {
                    for (uint32_t i = 0; i < l; ++i) d[i] = p[i];
                }
                di += l;
            } else {
                emit_careful(p, l);
                if (__builtin_expect(di >= dst_len, 0)) {
                    // dst is full (clipped over-long stream): stop HERE even
                    // in bulk mode — the pair's second code would otherwise
                    // take the unchecked fast emit and write past dst.
                    return 1;
                }
                // A careful emit can leave di past safe_end WITHOUT filling
                // dst (di in (safe_end, dst_len)); in bulk mode the pair's
                // second fast emit would then write its fixed 16 bytes
                // across dst_len — hand the rest of the stream to the
                // checked tail loop instead.
                if (bulk) tail_handoff = true;
            }
            prev_len = l;
            next_code += (next_code < kMaxCode);  // park when full
            // TIFF early change: bump width one code early
            if (next_code == (1 << code_bits) - 1 && code_bits < 12) {
                ++code_bits;
                code_mask = (1u << code_bits) - 1;
            }
        }
        if (bulk) return tail_handoff ? 2 : 0;
        return __builtin_expect(di >= dst_len, 0) ? 1 : 0;
    };

    // Bulk steady-state loop: while the read head stays >=16 bytes from the
    // stream end AND the write head >=48 bytes from the dst end, no tail
    // handling is reachable — the window load always has 8 full bytes, two
    // codes always fit in the remaining bits, and a pair's two <=16-byte
    // fast emits always fit the slack — so the only boundary work left is
    // ONE fused test per pair (measured: wins every interleaved pair vs the
    // single tail-checking loop, ~+20% median on the bench corpus; long
    // strings with l > 16 still take the checked slow branch inside step).
    bool done = false;
    while (!done && ((bitpos >> 3) + 16 <= src_len) & (di + 48 <= dst_len)) {
        size_t byte = bitpos >> 3;
        uint64_t w;
        std::memcpy(&w, src + byte, 8);
        w = __builtin_bswap64(w);
        int sh = (int)(bitpos & 7);
        int cb = code_bits;
        int code = (int)((w >> (64 - sh - cb)) & code_mask);
        bitpos += cb;
        int rc = step(code, true);
        if (__builtin_expect(rc != 0, 0)) {
            if (rc < 0) return false;
            if (rc == 2) break;  // tail handoff: continue in the checked loop
            done = true;
            break;
        }
        // Second code from the SAME 64-bit window: one load + bswap per
        // pair instead of per code (sh <= 7 and cb <= 12, so two codes
        // always fit in 64 bits).  Skipped on the rare width change
        // (early-change bump or Clear reset).
        if (__builtin_expect(code_bits == cb, 1)) {
            code = (int)((w >> (64 - sh - 2 * cb)) & code_mask);
            bitpos += cb;
            rc = step(code, true);
            if (__builtin_expect(rc != 0, 0)) {
                if (rc < 0) return false;
                if (rc == 2) break;
                done = true;
                break;
            }
        }
    }
    // Careful tail loop: same pair structure with every boundary check on
    // (short final window, partial pairs, emits clipping at dst_len).
    while (!done) {
        if (__builtin_expect(bitpos + code_bits > total_bits, 0)) break;
        size_t byte = bitpos >> 3;
        uint64_t w;
        bool full_window = byte + 8 <= src_len;
        if (__builtin_expect(full_window, 1)) {
            std::memcpy(&w, src + byte, 8);
            w = __builtin_bswap64(w);
        } else {  // last <8 bytes of the stream
            w = 0;
            for (size_t i = 0; i < 8; ++i)
                w = (w << 8) | (byte + i < src_len ? src[byte + i] : 0);
        }
        int sh = (int)(bitpos & 7);
        int cb = code_bits;
        int code = (int)((w >> (64 - sh - cb)) & code_mask);
        bitpos += cb;
        int rc = step(code, false);
        if (__builtin_expect(rc != 0, 0)) {
            if (rc < 0) return false;
            break;
        }
        if (__builtin_expect(
                code_bits == cb && full_window &&
                    bitpos + cb <= total_bits, 1)) {
            code = (int)((w >> (64 - sh - 2 * cb)) & code_mask);
            bitpos += cb;
            rc = step(code, false);
            if (__builtin_expect(rc != 0, 0)) {
                if (rc < 0) return false;
                break;
            }
        }
    }
    if (di != dst_len) {
        *err = "short LZW stream (truncated or corrupt strip)";
        return false;
    }
    return true;
}

void undo_predictor(uint8_t* row, uint32_t width, uint16_t bits,
                    uint16_t samples) {
    if (bits == 8) {
        for (uint32_t i = samples; i < width * samples; ++i)
            row[i] = (uint8_t)(row[i] + row[i - samples]);
    } else if (bits == 16) {
        uint16_t* r16 = reinterpret_cast<uint16_t*>(row);
        uint32_t n = width * samples;
#if defined(__SSE2__)
        if (samples == 1) {
            // Predictor-2 undo == inclusive prefix sum (mod 2^16) of the
            // row.  The scalar loop is a 1-add-per-pixel serial dependency
            // chain (~12% of whole-file decode, native/bench_decode.cc);
            // log-step shift-adds compute 8 lanes per chain step instead.
            __m128i carry = _mm_setzero_si128();
            uint32_t i = 0;
            for (; i + 8 <= n; i += 8) {
                __m128i x = _mm_loadu_si128(
                    reinterpret_cast<const __m128i*>(r16 + i));
                x = _mm_add_epi16(x, _mm_slli_si128(x, 2));
                x = _mm_add_epi16(x, _mm_slli_si128(x, 4));
                x = _mm_add_epi16(x, _mm_slli_si128(x, 8));
                x = _mm_add_epi16(x, carry);
                _mm_storeu_si128(reinterpret_cast<__m128i*>(r16 + i), x);
                // broadcast lane 7 (the row's running sum) to all lanes
                carry = _mm_shufflehi_epi16(x, _MM_SHUFFLE(3, 3, 3, 3));
                carry = _mm_unpackhi_epi64(carry, carry);
            }
            uint16_t c = i ? r16[i - 1] : 0;
            for (; i < n; ++i) {
                c = (uint16_t)(c + r16[i]);
                r16[i] = c;
            }
            return;
        }
#endif
        for (uint32_t i = samples; i < n; ++i)
            r16[i] = (uint16_t)(r16[i] + r16[i - samples]);
    }
}

bool load_file(const char* path, Reader* r, std::string* err) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) { *err = "cannot open file"; return false; }
    struct stat st;
    if (::fstat(fd, &st) != 0 || st.st_size < 0) {
        ::close(fd);
        *err = "cannot stat file";
        return false;
    }
    size_t sz = (size_t)st.st_size;
    if (sz >= 8) {
        void* m = ::mmap(nullptr, sz, PROT_READ, MAP_PRIVATE, fd, 0);
        if (m != MAP_FAILED) {
            ::madvise(m, sz, MADV_WILLNEED);
            r->map_base_ = m;
            r->map_len_ = sz;
            r->ptr = (const uint8_t*)m;
            r->size = sz;
        }
    }
    if (r->ptr == nullptr) {  // mmap refused (or tiny file): buffered read
        r->heap_.resize(sz);
        FILE* f = ::fdopen(::dup(fd), "rb");
        size_t got = f ? std::fread(r->heap_.data(), 1, sz, f) : 0;
        if (f) std::fclose(f);
        if (got != sz) {
            ::close(fd);
            *err = "short read";
            return false;
        }
        r->ptr = r->heap_.data();
        r->size = sz;
    }
    ::close(fd);
    if (sz < 8) { *err = "not a TIFF"; return false; }
    if (r->ptr[0] == 'I' && r->ptr[1] == 'I') r->big_endian = false;
    else if (r->ptr[0] == 'M' && r->ptr[1] == 'M') r->big_endian = true;
    else { *err = "not a TIFF"; return false; }
    uint16_t version = r->u16(2);
    if (version == 43) {  // BigTIFF: u16 offset size (8), u16 zero pad
        if (sz < 16 || r->u16(4) != 8 || r->u16(6) != 0) {
            *err = "malformed BigTIFF header";
            return false;
        }
        r->bigtiff = true;
    } else if (version != 42) {
        *err = "not a TIFF (bad version)";
        return false;
    }
    return true;
}

// PackBits (compression 32773): signed-count byte RLE.  Mirrors the LZW
// contract: a strip must fill dst exactly (short input -> error) and an
// over-long stream clips at dst_len (accepted, like the PIL/tifffile path).
bool packbits_decode(const uint8_t* src, size_t src_len, uint8_t* dst,
                     size_t dst_len, std::string* err) {
    size_t si = 0, di = 0;
    while (di < dst_len) {
        if (si >= src_len) {
            *err = "short PackBits strip";
            return false;
        }
        int8_t n = (int8_t)src[si++];
        if (n >= 0) {  // n+1 literal bytes
            size_t l = (size_t)n + 1;
            // clip BEFORE the src bound check: a stream whose final literal
            // packet fills dst but is stored truncated past the dst-filling
            // byte is accepted by PIL (it stops once dst fills) — only the
            // bytes we actually need must be present.
            if (l > dst_len - di) l = dst_len - di;
            if (si + l > src_len) {
                *err = "short PackBits strip";
                return false;
            }
            std::memcpy(dst + di, src + si, l);
            si += l;
            di += l;
        } else if (n != -128) {  // repeat next byte 1-n times (-128: noop)
            if (si >= src_len) {
                *err = "short PackBits strip";
                return false;
            }
            size_t l = (size_t)(1 - (int)n);
            if (l > dst_len - di) l = dst_len - di;
            std::memset(dst + di, src[si++], l);
            di += l;
        }
    }
    return true;
}

// Deflate (compression 8 "Adobe" / 32946 "old-style"): each strip is one
// zlib stream.  Same fill contract as LZW/PackBits.
bool deflate_decode(const uint8_t* src, size_t src_len, uint8_t* dst,
                    size_t dst_len, std::string* err) {
    if (src_len > UINT32_MAX || dst_len > UINT32_MAX) {
        // zlib's avail_in/avail_out are uInt; silent truncation would
        // misreport a huge crafted strip as short/clipped
        *err = "deflate strip too large";
        return false;
    }
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) {
        *err = "inflateInit failed";
        return false;
    }
    zs.next_in = const_cast<Bytef*>(src);
    zs.avail_in = (uInt)src_len;
    zs.next_out = dst;
    zs.avail_out = (uInt)dst_len;
    int zrc = inflate(&zs, Z_FINISH);
    bool full = zs.avail_out == 0;
    inflateEnd(&zs);
    // dst exactly filled (stream may continue past it: over-long strips
    // clip, like the LZW path) = ok; a stream that ENDS before dst fills
    // is a short strip; anything else is corrupt.
    if (full) return true;
    *err = zrc == Z_STREAM_END ? "short deflate strip"
                               : "corrupt deflate strip";
    return false;
}

int validate_page(const TiffPage& pg, std::string* err) {
    if (pg.compression != 1 && pg.compression != 5 &&
        pg.compression != 8 && pg.compression != 32946 &&
        pg.compression != 32773) {
        *err = "unsupported compression";
        return -3;
    }
    if (pg.bits == 32) {
        // float32 only (what core.tiffio.write_tiff32 emits); predictor 2
        // is integer differencing and predictor 3 (fp) is unimplemented —
        // reject both so callers fall back to PIL
        if (pg.sample_format != 3 || pg.predictor != 1) {
            *err = "unsupported 32-bit variant";
            return -4;
        }
    } else if (pg.bits != 8 && pg.bits != 16) {
        *err = "unsupported bit depth";
        return -4;
    } else if (pg.sample_format != 1 && pg.sample_format != 4) {
        // 8/16-bit pages are decoded as unsigned ints; signed (2) or
        // float-half (3) bit patterns would silently read as garbage —
        // reject so callers fall back to PIL, which honors SampleFormat.
        // 4 = "undefined", conventionally read as unsigned (like PIL).
        *err = "unsupported sample format";
        return -4;
    }
    return 0;
}

// Decode one parsed page into out.  max_threads==1 runs inline (used by the
// batch call, whose parallelism is per-file); otherwise strips fan out over
// up to hardware_concurrency threads.
//
// When hist != nullptr (65536 caller-zeroed bins) and the page is 16-bit,
// a strided histogram of the flat pixel sequence out[::hist_stride] is
// accumulated DURING the per-strip pass — the rows are still cache-hot
// from the LZW/predictor write, so the host background percentile costs
// no second 6 MB scan (the separate u16 counting pass it replaces).
void accumulate_row_hist(const uint8_t* row_bytes, uint32_t width,
                         size_t flat_start, long long stride,
                         uint32_t* hist) {
    const uint16_t* px = reinterpret_cast<const uint16_t*>(row_bytes);
    size_t first = (size_t)((stride - (long long)(flat_start % stride)) %
                            stride);
    for (size_t c = first; c < width; c += (size_t)stride) ++hist[px[c]];
}

// Tiled layout (tags 322-325, e.g. OME-TIFF exports): each tile is an
// independently compressed tw x th block, row-major over the tile grid;
// edge tiles are padded to the FULL tile size in the stream (TIFF6 spec),
// so every tile decodes into a full scratch block and only the valid
// region copies into place.  Predictor and byteswap apply per TILE row.
// Tiles fan out over threads like strips (disjoint output regions;
// per-thread scratch + local histogram merged under the mutex).
int decode_page_tiled(const Reader& r, const TiffPage& pg, uint8_t* out,
                      unsigned max_threads, std::string* err,
                      uint32_t* hist, long long hist_stride) {
    const uint32_t tw = pg.tile_width, th = pg.tile_height;
    if (tw == 0 || th == 0) {
        *err = "tiled page missing TileWidth or TileLength";
        return -3;
    }
    size_t bytes_per_px = (pg.bits / 8) * pg.samples;
    size_t tile_row_bytes = (size_t)tw * bytes_per_px;
    if (th != 0 && tile_row_bytes != 0 &&
        tile_row_bytes > SIZE_MAX / th) {
        *err = "tile dimensions overflow";
        return -5;
    }
    size_t tile_bytes = tile_row_bytes * th;
    if (tile_bytes == 0 || tile_bytes > (64u << 20)) {
        // 64 MB/tile sanity bound: real tiles are 16-512 KB; a crafted
        // 4-Gpix tile must not drive a giant allocation
        *err = "unreasonable tile size";
        return -5;
    }
    size_t across = ((size_t)pg.width + tw - 1) / tw;
    size_t down = ((size_t)pg.height + th - 1) / th;
    size_t n_tiles = across * down;
    if (pg.strip_offsets.size() < n_tiles) {
        *err = "missing tiles";
        return -6;
    }
    size_t row_bytes = (size_t)pg.width * bytes_per_px;
    std::atomic<int> rc{0};
    std::mutex err_mu;
    // honor the caller's max_threads directly (the public entries pass
    // hardware_concurrency; tests pass explicit counts so the concurrent
    // path is exercised even on a 1-core box)
    size_t n_threads = max_threads < n_tiles ? max_threads : n_tiles;
    if (n_threads == 0) n_threads = 1;

    auto work = [&](size_t tid) {
        std::vector<uint8_t> scratch(tile_bytes);
        std::string werr;
        std::vector<uint32_t> local_hist;
        uint32_t* h = hist;
        if (hist && n_threads > 1) {
            local_hist.assign(65536, 0);
            h = local_hist.data();
        }
        for (size_t t = tid; t < n_tiles; t += n_threads) {
            uint32_t x0 = (uint32_t)(t % across) * tw;
            uint32_t y0 = (uint32_t)(t / across) * th;
            uint64_t off = pg.strip_offsets[t];
            uint64_t cnt = t < pg.strip_counts.size() ? pg.strip_counts[t]
                                                      : (uint64_t)tile_bytes;
            if (off > r.size || cnt > r.size - off) {
                rc = -6;
                std::lock_guard<std::mutex> g(err_mu);
                *err = "tile outside file";
                return;
            }
            bool ok;
            if (pg.compression == 1) {
                ok = cnt >= tile_bytes;
                if (ok) std::memcpy(scratch.data(), r.ptr + off, tile_bytes);
                else werr = "short uncompressed tile";
            } else if (pg.compression == 5) {
                ok = lzw_decode(r.ptr + off, cnt, scratch.data(), tile_bytes,
                                &werr);
            } else if (pg.compression == 32773) {
                ok = packbits_decode(r.ptr + off, cnt, scratch.data(),
                                     tile_bytes, &werr);
            } else {
                ok = deflate_decode(r.ptr + off, cnt, scratch.data(),
                                    tile_bytes, &werr);
            }
            if (!ok) {
                rc = -7;
                std::lock_guard<std::mutex> g(err_mu);
                *err = werr;
                return;
            }
            if (pg.bits == 16 && r.big_endian) {
                for (size_t i = 0; i + 1 < tile_bytes; i += 2) {
                    uint8_t b = scratch[i];
                    scratch[i] = scratch[i + 1];
                    scratch[i + 1] = b;
                }
            } else if (pg.bits == 32 && r.big_endian) {
                for (size_t i = 0; i + 3 < tile_bytes; i += 4) {
                    uint8_t b = scratch[i];
                    scratch[i] = scratch[i + 3];
                    scratch[i + 3] = b;
                    b = scratch[i + 1];
                    scratch[i + 1] = scratch[i + 2];
                    scratch[i + 2] = b;
                }
            }
            if (pg.predictor == 2) {
                for (uint32_t rr = 0; rr < th; ++rr)
                    undo_predictor(scratch.data() + tile_row_bytes * rr, tw,
                                   pg.bits, pg.samples);
            }
            // 64-bit edge clamps: with width within tile_width of 2^32
            // the 32-bit `x0 + vw` wraps past the clamp and the full-tile
            // copy writes past the caller's buffer (same class as the
            // strip path's crafted-RowsPerStrip wrap)
            uint32_t vw = tw, vh = th;
            if ((uint64_t)x0 + vw > pg.width) vw = pg.width - x0;
            if ((uint64_t)y0 + vh > pg.height) vh = pg.height - y0;
            size_t copy_bytes = (size_t)vw * bytes_per_px;
            for (uint32_t rr = 0; rr < vh; ++rr) {
                uint8_t* dst_row = out + (size_t)(y0 + rr) * row_bytes +
                                   (size_t)x0 * bytes_per_px;
                std::memcpy(dst_row, scratch.data() + tile_row_bytes * rr,
                            copy_bytes);
                if (hist && pg.bits == 16 && pg.samples == 1 &&
                    hist_stride >= 1)
                    accumulate_row_hist(dst_row, vw,
                                        (size_t)(y0 + rr) * pg.width + x0,
                                        hist_stride, h);
            }
        }
        if (!local_hist.empty()) {
            std::lock_guard<std::mutex> g(err_mu);
            for (int v = 0; v < 65536; ++v) hist[v] += local_hist[v];
        }
    };

    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        pool.reserve(n_threads);
        for (size_t tid = 0; tid < n_threads; ++tid)
            pool.emplace_back(work, tid);
        for (auto& th_ : pool) th_.join();
    }
    return rc.load();
}

int decode_page(const Reader& r, const TiffPage& pg, uint8_t* out,
                long long out_bytes, unsigned max_threads, std::string* err,
                uint32_t* hist = nullptr, long long hist_stride = 0) {
    size_t bytes_per_px = (pg.bits / 8) * pg.samples;
    size_t row_bytes = (size_t)pg.width * bytes_per_px;
    // overflow-checked total: a crafted width*height*spp near 2^64 would
    // wrap `need` below the caller's allocation and defeat the size check
    if (pg.height != 0 && row_bytes != 0 &&
        row_bytes > SIZE_MAX / pg.height) {
        *err = "page dimensions overflow"; return -5;
    }
    size_t need = row_bytes * pg.height;
    // unsigned compare: need in [2^63, 2^64) would cast to a NEGATIVE
    // long long and sail past a signed check
    if (out_bytes < 0 || need > (unsigned long long)out_bytes) {
        *err = "output buffer too small"; return -5;
    }

    if (pg.tile_width || pg.tile_height)
        return decode_page_tiled(r, pg, out, max_threads, err, hist,
                                 hist_stride);

    size_t n_strips = pg.strip_offsets.size();
    std::atomic<int> rc{0};
    std::mutex err_mu;
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    if (hw > max_threads) hw = max_threads;
    size_t n_threads = hw < n_strips ? hw : n_strips;
    if (n_threads == 0) n_threads = 1;

    auto work = [&](size_t tid) {
        std::string werr;
        // multi-threaded histogram accumulation goes to per-thread bins,
        // merged once under the mutex at the end of the thread's strips
        std::vector<uint32_t> local_hist;
        uint32_t* h = hist;
        if (hist && n_threads > 1) {
            local_hist.assign(65536, 0);
            h = local_hist.data();
        }
        for (size_t s = tid; s < n_strips; s += n_threads) {
            // 64-bit strip geometry: with a crafted rows_per_strip near
            // 2^32, 32-bit `s * rows_per_strip` truncation and
            // `row0 + rows` wrap-around both defeat the height clamp and
            // turn the strip decode into an out-of-bounds write
            uint64_t row0_64 = (uint64_t)s * pg.rows_per_strip;
            if (row0_64 >= pg.height) continue;
            uint32_t row0 = (uint32_t)row0_64;
            uint32_t rows = pg.rows_per_strip;
            if (row0_64 + rows > pg.height) rows = pg.height - row0;
            size_t strip_bytes = row_bytes * rows;
            uint8_t* dst = out + row_bytes * row0;
            uint64_t off = pg.strip_offsets[s];
            uint64_t cnt = s < pg.strip_counts.size() ? pg.strip_counts[s]
                                                      : (uint64_t)strip_bytes;
            if (off > r.size || cnt > r.size - off) {
                rc = -6;
                std::lock_guard<std::mutex> g(err_mu);
                *err = "strip outside file";
                return;
            }
            if (pg.compression == 1) {
                if (cnt < strip_bytes) {
                    rc = -6;
                    std::lock_guard<std::mutex> g(err_mu);
                    *err = "short uncompressed strip";
                    return;
                }
                std::memcpy(dst, r.ptr + off, strip_bytes);
            } else {
                bool ok;
                if (pg.compression == 5) {
                    ok = lzw_decode(r.ptr + off, cnt, dst, strip_bytes,
                                    &werr);
                } else if (pg.compression == 32773) {
                    ok = packbits_decode(r.ptr + off, cnt, dst, strip_bytes,
                                         &werr);
                } else {  // 8 / 32946: zlib deflate
                    ok = deflate_decode(r.ptr + off, cnt, dst, strip_bytes,
                                        &werr);
                }
                if (!ok) {
                    rc = -7;
                    std::lock_guard<std::mutex> g(err_mu);
                    *err = werr;
                    return;
                }
            }
            // byte order fix for 16/32-bit big-endian files
            if (pg.bits == 16 && r.big_endian) {
                for (size_t i = 0; i + 1 < strip_bytes; i += 2) {
                    uint8_t t = dst[i];
                    dst[i] = dst[i + 1];
                    dst[i + 1] = t;
                }
            } else if (pg.bits == 32 && r.big_endian) {
                for (size_t i = 0; i + 3 < strip_bytes; i += 4) {
                    uint8_t t = dst[i]; dst[i] = dst[i + 3]; dst[i + 3] = t;
                    t = dst[i + 1]; dst[i + 1] = dst[i + 2]; dst[i + 2] = t;
                }
            }
            if (pg.predictor == 2) {
                for (uint32_t rr = 0; rr < rows; ++rr)
                    undo_predictor(dst + row_bytes * rr, pg.width, pg.bits,
                                   pg.samples);
            }
            if (hist && pg.bits == 16 && pg.samples == 1 &&
                hist_stride >= 1) {
                for (uint32_t rr = 0; rr < rows; ++rr)
                    accumulate_row_hist(
                        dst + row_bytes * rr, pg.width,
                        (size_t)(row0 + rr) * pg.width, hist_stride, h);
            }
        }
        if (!local_hist.empty()) {
            std::lock_guard<std::mutex> g(err_mu);
            for (int v = 0; v < 65536; ++v) hist[v] += local_hist[v];
        }
    };

    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (size_t t = 0; t < n_threads; ++t) pool.emplace_back(work, t);
        for (auto& th : pool) th.join();
    }
    return rc.load();
}

int decode_one(const char* path, int page, uint8_t* out, long long out_bytes,
               unsigned max_threads, std::string* err) {
    Reader r;
    if (!load_file(path, &r, err)) return -1;
    TiffPage pg;
    if (!parse_page(r, page, &pg, err)) return -2;
    int rc = validate_page(pg, err);
    if (rc != 0) return rc;
    return decode_page(r, pg, out, out_bytes, max_threads, err);
}

}  // namespace

extern "C" {

const char* ip_tiff_error() { return g_error.c_str(); }

int ip_tiff_info(const char* path, int page, int* height, int* width,
                 int* bits_per_sample, int* samples_per_pixel) {
    Reader r;
    if (!load_file(path, &r, &g_error)) return -1;
    TiffPage pg;
    if (!parse_page(r, page, &pg, &g_error)) return -2;
    int rc = validate_page(pg, &g_error);
    if (rc != 0) return rc;
    *height = (int)pg.height;
    *width = (int)pg.width;
    *bits_per_sample = (int)pg.bits;
    *samples_per_pixel = (int)pg.samples;
    return 0;
}

int ip_tiff_decode(const char* path, int page, uint8_t* out,
                   long long out_bytes) {
    unsigned hw = std::thread::hardware_concurrency();
    return decode_one(path, page, out, out_bytes, hw ? hw : 1, &g_error);
}

double ip_u16_percentile_strided(const uint16_t* buf, long long n_total,
                                 long long stride, int p1000) {
    // Exact np.percentile (method="linear") of buf[::stride] for u16 data,
    // via a 65536-bin counting pass + integer order-statistic lookup —
    // O(n) with no sort.  Matches the reference's host background
    // percentile (src/INT/Fluor_INT.py:461-492, vals[::stride]) bit-for-bit
    // for integer pixel values.  p1000 = percentile in thousandths.
    if (stride < 1) stride = 1;
    std::vector<uint32_t> hist(65536, 0);
    long long n = 0;
    for (long long i = 0; i < n_total; i += stride) {
        ++hist[buf[i]];
        ++n;
    }
    if (n == 0) return 0.0;
    long long idx = (n - 1) * (long long)p1000;
    long long k = idx / 100000;
    double g = (double)(idx % 100000) / 100000.0;
    long long k1 = k + 1 <= n - 1 ? k + 1 : k;
    long long c = 0;
    int lo = -1, hi = -1;
    for (int v = 0; v < 65536; ++v) {
        c += hist[v];
        if (lo < 0 && c >= k + 1) lo = v;
        if (c >= k1 + 1) { hi = v; break; }
    }
    if (hi < 0) hi = lo;
    return (double)lo + g * (double)(hi - lo);
}

void ip_u16_hist(const uint16_t* buf, long long n_total, long long stride,
                 uint32_t* hist /* 65536, caller-zeroed */) {
    // One counting pass serving every order statistic the caller needs
    // (background percentile AND the FRET eps quantile come from the same
    // histogram — one frame scan instead of one per statistic).
    if (stride < 1) stride = 1;
    for (long long i = 0; i < n_total; i += stride) ++hist[buf[i]];
}

int ip_tiff_decode_batch_hist_tiles(
    const char** paths, int n_files, int page, uint8_t* out,
    long long frame_bytes, int height, int width, int bits, int samples,
    long long hist_stride, uint32_t* hists, int n_tiles, int tile,
    const int32_t* offs /* n_tiles x [oy, ox] */,
    uint8_t* tiles_out /* (n_tiles, n_files, tile, tile) element grid */) {
    // Decode n same-shaped files into one contiguous buffer, one worker
    // thread per file; the per-file strip decode runs single-threaded so
    // the pool never oversubscribes (file-level parallelism is the right
    // granularity for whole-experiment loads).  Each file's shape must
    // match (height, width, bits, samples) — a smaller frame decoding into
    // a larger slot would silently misalign rows.
    //
    // When hists != nullptr (n_files x 65536 caller-zeroed bins) and
    // hist_stride >= 1, each 16-bit file also accumulates the strided
    // histogram of its flat pixels during the decode pass — the host
    // background/eps percentiles then cost no second frame scan.
    //
    // When n_tiles > 0, each worker additionally copies the requested ROI
    // tile rectangles out of its just-decoded (cache-warm) frame into
    // tiles_out[ti][file] — the batched runners' Python-side gather (numpy
    // slicing under the GIL, racing the other prefetch threads on the
    // 1-core host) disappears, and the whole per-key host pipeline
    // (decode + histogram + tile gather) is ONE GIL-free native call
    // (pipelines/intensity.py `_load`; reference analogue: the
    // ProcessPoolExecutor worker body, src/INT/Fluor_INT.py:2216-2229).
    // Single-sample frames only.
    if (n_tiles > 0) {
        if (samples != 1) {
            g_error = "tile extraction requires samples == 1";
            return -9;
        }
        if (!tiles_out || !offs) {
            g_error = "tile extraction requires offs and tiles_out";
            return -9;
        }
        for (int ti = 0; ti < n_tiles; ++ti) {
            int32_t oy = offs[2 * ti], ox = offs[2 * ti + 1];
            if (oy < 0 || ox < 0 || oy + tile > height || ox + tile > width) {
                g_error = "tile offset out of bounds";
                return -9;
            }
        }
    }
    std::atomic<int> rc{0};
    std::atomic<int> next{0};
    std::mutex err_mu;
    std::string first_err;
    unsigned hw = std::thread::hardware_concurrency();
    size_t n_threads = hw ? (hw < (unsigned)n_files ? hw : (unsigned)n_files) : 1;

    auto work = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n_files) return;
            std::string err;
            Reader r;
            int frc = 0;
            if (!load_file(paths[i], &r, &err)) frc = -1;
            TiffPage pg;
            if (frc == 0 && !parse_page(r, page, &pg, &err)) frc = -2;
            if (frc == 0) frc = validate_page(pg, &err);
            if (frc == 0 &&
                ((int)pg.height != height || (int)pg.width != width ||
                 (int)pg.bits != bits || (int)pg.samples != samples)) {
                err = "batch shape mismatch: " + std::string(paths[i]);
                frc = -8;
            }
            if (frc == 0)
                frc = decode_page(r, pg, out + (long long)i * frame_bytes,
                                  frame_bytes, 1, &err,
                                  hists ? hists + (size_t)i * 65536 : nullptr,
                                  hist_stride);
            if (frc == 0 && n_tiles > 0) {
                const long long esize = bits / 8;
                const long long row_bytes = (long long)tile * esize;
                const uint8_t* frame = out + (long long)i * frame_bytes;
                for (int ti = 0; ti < n_tiles; ++ti) {
                    const long long oy = offs[2 * ti], ox = offs[2 * ti + 1];
                    uint8_t* dst = tiles_out +
                        (((long long)ti * n_files + i) * tile) * row_bytes;
                    const uint8_t* src =
                        frame + (oy * (long long)width + ox) * esize;
                    for (int rr = 0; rr < tile; ++rr)
                        memcpy(dst + (long long)rr * row_bytes,
                               src + (long long)rr * width * esize, row_bytes);
                }
            }
            if (frc != 0) {
                rc = frc;
                std::lock_guard<std::mutex> g(err_mu);
                if (first_err.empty())
                    first_err = err + " [" + std::string(paths[i]) + "]";
            }
        }
    };
    if (n_threads <= 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        for (size_t t = 0; t < n_threads; ++t) pool.emplace_back(work);
        for (auto& th : pool) th.join();
    }
    // propagate worker error text to the calling thread's error slot
    if (rc.load() != 0) g_error = first_err;
    return rc.load();
}

int ip_tiff_decode_batch_hist(const char** paths, int n_files, int page,
                              uint8_t* out, long long frame_bytes,
                              int height, int width, int bits, int samples,
                              long long hist_stride, uint32_t* hists) {
    return ip_tiff_decode_batch_hist_tiles(paths, n_files, page, out,
                                           frame_bytes, height, width, bits,
                                           samples, hist_stride, hists,
                                           0, 0, nullptr, nullptr);
}

int ip_tiff_decode_batch(const char** paths, int n_files, int page,
                         uint8_t* out, long long frame_bytes,
                         int height, int width, int bits, int samples) {
    return ip_tiff_decode_batch_hist(paths, n_files, page, out, frame_bytes,
                                     height, width, bits, samples, 0,
                                     nullptr);
}

}  // extern "C"
