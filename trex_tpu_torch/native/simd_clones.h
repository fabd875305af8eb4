// Runtime SIMD dispatch for hot native kernels.
//
// The library ships portable (baseline x86-64, no -march): the
// reference distributes portable conda binaries the same way. But the
// elementwise hot loops (background diff + threshold over full frames,
// crop diffs, distance matrices) vectorize 4-8x wider on AVX2/AVX-512
// hosts. GCC/Clang function multi-versioning compiles extra clones of
// the annotated function per target and selects via ifunc at load time
// — one binary, portable default, full-width fast path when the CPU
// has it.
//
// Bit-exactness: -ffp-contract=off stays in force for every clone, and
// neither compiler vectorizes float reductions without -ffast-math, so
// cloned functions produce byte-identical results to the portable
// build (elementwise FP vectorization is IEEE-exact per lane). Only
// integer/byte loops actually widen.
#pragma once

#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__)) \
    && !defined(TREX_NO_SIMD_CLONES)
#define TREX_HOT_CLONES \
    __attribute__((target_clones("default", "arch=x86-64-v3", \
                                 "arch=x86-64-v4")))
#else
#define TREX_HOT_CLONES
#endif
