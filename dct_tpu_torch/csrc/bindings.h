// Plain C interface of the port's CUDA kernels, loaded from Python with
// ctypes (dct_tpu_torch/ops/_build.py declares the same signatures).
//
// Every pointer is a device pointer taken from a contiguous torch tensor;
// `stream` is the caller's cudaStream_t (torch.cuda.current_stream()).
// Each launcher enqueues one kernel on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() as an int (0 = the
// launch was accepted).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DCT_EXPORT extern "C" __attribute__((visibility("default")))

// Kernel A: (n_blocks, n2) u8 pixel blocks -> (n_blocks, n2) int32
// quantized zigzag coefficients, n2 4, 16, 64 or 256, px 16-byte aligned.
// frag: the integer operator's byte planes in the tile's B-fragment order,
// 4 P^2 bytes (P = max(n2, 32)); cert: (P, 8) int32 certificate
// constants (tables.certificate_constants); parts: (3, n2, n2) float32
// bf16 parts (row j = pixel), for the rescue; bias: the float32 encode bias (its first n2 entries are read);
// recip: (n_blocks,) reciprocal adaptive scale, or NULL (tables.py
// CodecOperators). rescued: one uint64 in device memory, to which the
// kernel adds the coefficients its float32 chain computed.
DCT_EXPORT int dct_encode_blocks(const void* px, const void* frag,
                                 const void* cert, const void* parts,
                                 const void* bias, const void* recip,
                                 void* out, long long n_blocks, int n2,
                                 void* rescued, void* stream);

// The tensor-core tile's integer products alone (a test of it):
// (n_rows, p) u8 packed rows, p 32, 64 or 256, and frag as above ->
// (n_rows, p) int64 x @ W (W of tables.certificate_operator).
DCT_EXPORT int dct_mma_products(const void* px, const void* frag, void* out,
                                int n_rows, int p, void* stream);

// Kernel C: (n_blocks, n2) int16 zigzag coefficients -> (n_blocks, n2) u8
// pixels. m_dec: float32 decode operator, row stride ld. scale:
// (n_blocks,) adaptive scale, or NULL.
DCT_EXPORT int dct_decode_blocks(const void* zz, const void* m_dec, int ld,
                                 const void* scale, void* out,
                                 long long n_blocks, int n2, void* stream);

// Kernel B: a persistent grid (SMs x CTAs an SM, at most n_stripes CTAs)
// walking the stripes, n2 16, 64 or 256, stripes of any width. px, by
// plane_width:
// 0: (n_stripes * bps, n2) u8 blocks, 16-byte aligned; else the padded
// plane(s), rows of plane_width bytes (a multiple of the block side n),
// n_stripes * bps * n2 bytes in all, 16-byte aligned, stripe s starting at
// byte s * bps * n2 (bps = (rows a stripe) * plane_width / n). frag, cert,
// parts, bias, recip, rescued: as kernel A's. mode: 0 category, 1 direct, 2 none.
// val_len/val_code: the value table's n_val int32 entries (16 categories;
// 512 in direct mode, values -255..255 and ESC last; n_val 0 in "none"
// mode). run_len/run_code: (65,) int32 run table, or NULL for the fixed
// run_bits-wide run field. words: (n_stripes, n_words) int32 output, each
// word holding two 16-bit units with its halves swapped, so that the
// buffer read as int16 is the unit stream in order; every word is stored
// once, zeros past each stripe's payload included. stripe_bits:
// (n_stripes,) int32; block_bits: (n_stripes, bps) int32.
DCT_EXPORT int dct_encode_stripes(const void* px, const void* frag,
                                  const void* cert, const void* parts,
                                  const void* bias, const void* recip,
                                  const void* val_len, const void* val_code,
                                  int n_val, const void* run_len,
                                  const void* run_code, int run_bits,
                                  int mode, int dc_prediction, int n2,
                                  int n_stripes, int bps, int plane_width,
                                  void* words, int n_words, void* stripe_bits,
                                  void* block_bits, void* rescued,
                                  void* stream);

// The adaptive encode's variance pass: padded u8 plane(s) px, rows * n
// pixel rows of `width` bytes (n the block side of n2 16, 64 or 256; width
// a multiple of n) -> codes: one u8 variance code a block and recip: one
// float32 1 / scale a block, raster order over every plane (rows * width /
// n blocks), the reciprocal kernel B reads. px, codes and recip 16-byte
// aligned.
DCT_EXPORT int dct_variance_codes(const void* px, long long rows, int width,
                                  int n2, void* codes, void* recip,
                                  void* stream);

// Kernel B's launch shape on the current device, for n2 16, 64 or 256:
// out[0..6] = SMs, CTAs an SM, registers a thread, dynamic shared memory
// bytes a CTA, local (spilled) bytes a thread, threads a CTA, blocks a
// tile.
DCT_EXPORT int dct_encode_stripes_info(int n2, void* out);

// Kernel D: entropy decode of indexed (v2) stripes, one lane per block, a
// warp per 32 consecutive blocks. payload: (payload_bytes,) u8, the stripes
// concatenated, 16-byte aligned (bytes past the end read as zero).
// stripe_start: (n_stripes,) int64 first bit of each stripe; block_bits:
// (n_stripes, bps) u16 bit lengths, which the kernel scans into block
// starts. tabs: int32 packed tables (TABLE_FIELDS of
// ops/entropy_decode.py) followed by n_vtab direct values. out: (n_blocks,
// n2) int16 zigzag coefficients, n_blocks = n_stripes * bps, n2 4, 16, 64
// or 256. mode: 0 category, 1 direct, 2 none; run_bits: the fixed run
// field's width, 0 for coded runs. status: (n_blocks / bps,) int32
// zeros, or NULL; the kernel ORs 1 into the entry of each stripe in which
// a block contradicts its index.
DCT_EXPORT int dct_entropy_decode(const void* payload, long long payload_bytes,
                                  const void* stripe_start,
                                  const void* block_bits, int bps,
                                  const void* tabs, int n_vtab, void* out,
                                  long long n_blocks, int n2, int mode,
                                  int run_bits, void* status, void* stream);

// Kernel E: chunk packing, one CTA per stripe. cv/cl: (n_stripes,
// n_chunks) int32 chunk values and bit lengths (0..16; a value holds no bit
// above its length). words: (n_stripes, n_words) int32 output in kernel
// B's layout (halves swapped); units at or past `capacity` are dropped.
// stripe_bits: (n_stripes,) int32 sums of the lengths.
DCT_EXPORT int dct_pack_chunks(const void* cv, const void* cl, int n_stripes,
                               long long n_chunks, long long capacity,
                               void* words, long long n_words,
                               void* stripe_bits, void* stream);

// cudaGetErrorString of a code returned above.
DCT_EXPORT const char* dct_error_string(int code);
