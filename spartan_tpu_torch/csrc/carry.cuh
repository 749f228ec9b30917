// 32-bit carry-chain primitives for the multi-word field arithmetic of
// fq.cuh and fp25519.cuh.
//
// On the device each is one PTX instruction that reads and/or writes the
// carry flag CC.CF (add.cc, addc.cc, sub.cc, subc.cc, mad.lo.cc,
// madc.hi.cc, ...), so a chain of them compiles to a run of IADD3.X /
// IMAD.X-style instructions with the carry held in a predicate, not to
// 64-bit adds and shifts.  They are `asm volatile` so that the compiler
// keeps their order: the flag flows from one statement to the next.
//
// Without __CUDA_ARCH__ (nvcc's host pass, and g++ in
// tests/test_torch_csrc.py) the same primitives are plain C++ with the
// flag in a variable, so the chains built from them are checked on the
// host against python ints; the device code never runs them.
#pragma once
#include <stdint.h>

#if defined(__CUDA_ARCH__)

#define CC_OP3(name, ins)                                                  \
  static __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) { \
    uint32_t r;                                                            \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));           \
    return r;                                                              \
  }
#define CC_OP4(name, ins)                                                  \
  static __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,  \
                                                  uint32_t c) {            \
    uint32_t r;                                                            \
    asm volatile(ins " %0, %1, %2, %3;"                                    \
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));                      \
    return r;                                                              \
  }
CC_OP3(add_cc, "add.cc.u32")
CC_OP3(addc_cc, "addc.cc.u32")
CC_OP3(addc, "addc.u32")
CC_OP3(sub_cc, "sub.cc.u32")
CC_OP3(subc_cc, "subc.cc.u32")
CC_OP3(subc, "subc.u32")
CC_OP4(madlo_cc, "mad.lo.cc.u32")
CC_OP4(madloc_cc, "madc.lo.cc.u32")
CC_OP4(madloc, "madc.lo.u32")
CC_OP4(madhi_cc, "mad.hi.cc.u32")
CC_OP4(madhic_cc, "madc.hi.cc.u32")
CC_OP4(madhic, "madc.hi.u32")
#undef CC_OP3
#undef CC_OP4
static __device__ __forceinline__ uint32_t mullo(uint32_t a, uint32_t b) {
  return a * b;
}
static __device__ __forceinline__ uint32_t mulhi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}

#else

// CC.CF: a carry out of adds, a borrow out of subs
static __device__ uint32_t cc_flag;
#define CC_FN static __device__ __forceinline__ uint32_t
CC_FN cc_set(uint64_t s) {
  cc_flag = (uint32_t)(s >> 32) & 1u;
  return (uint32_t)s;
}
CC_FN add_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a + b); }
CC_FN addc_cc(uint32_t a, uint32_t b) {
  return cc_set((uint64_t)a + b + cc_flag);
}
CC_FN addc(uint32_t a, uint32_t b) { return a + b + cc_flag; }
CC_FN sub_cc(uint32_t a, uint32_t b) { return cc_set((uint64_t)a - b); }
CC_FN subc_cc(uint32_t a, uint32_t b) {
  return cc_set((uint64_t)a - b - cc_flag);
}
CC_FN subc(uint32_t a, uint32_t b) { return a - b - cc_flag; }
CC_FN mullo(uint32_t a, uint32_t b) { return a * b; }
CC_FN mulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
CC_FN madlo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return add_cc(mullo(a, b), c);
}
CC_FN madloc_cc(uint32_t a, uint32_t b, uint32_t c) {
  return addc_cc(mullo(a, b), c);
}
CC_FN madloc(uint32_t a, uint32_t b, uint32_t c) {
  return addc(mullo(a, b), c);
}
CC_FN madhi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return add_cc(mulhi(a, b), c);
}
CC_FN madhic_cc(uint32_t a, uint32_t b, uint32_t c) {
  return addc_cc(mulhi(a, b), c);
}
CC_FN madhic(uint32_t a, uint32_t b, uint32_t c) {
  return addc(mulhi(a, b), c);
}
#undef CC_FN

#endif
