// Double-float32 (compensated pair) arithmetic on the device, mirroring
// rmt_tpu_torch/ops/df32.py (itself a port of rmt_tpu/ops/df32.py)
// operation for operation, so the fused RHS kernel's df32 kinetics chain
// is the same function as its plain-PyTorch twin.
//
// The error-free transforms must never be contracted into FMAs: every
// add, subtract, multiply and divide is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), which nvcc
// never fuses, and the translation unit is built with -fmad=false too.

struct df {
  float hi, lo;
};

__device__ __forceinline__ float ad(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sb(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float ml(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ df df_f(float x) { return df{x, 0.0f}; }

__device__ __forceinline__ df two_sum(float a, float b) {
  const float s = ad(a, b);
  const float bb = sb(s, a);
  const float err = ad(sb(a, sb(s, bb)), sb(b, bb));
  return df{s, err};
}

__device__ __forceinline__ df quick_two_sum(float a, float b) {
  const float s = ad(a, b);
  return df{s, ad(sb(a, s), b)};
}

// NaN guard of the reference (a NaN product becomes 0)
__device__ __forceinline__ float opaque(float x) { return x == x ? x : 0.0f; }

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = opaque(ml(4097.0f, a));
  hi = sb(c, sb(c, a));
  lo = sb(a, hi);
}

__device__ __forceinline__ df two_prod(float a, float b) {
  const float p = opaque(ml(a, b));
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  const float err =
      ad(ad(ad(sb(ml(ah, bh), p), ml(ah, bl)), ml(al, bh)), ml(al, bl));
  return df{p, err};
}

__device__ __forceinline__ df df_neg(df x) { return df{-x.hi, -x.lo}; }

__device__ __forceinline__ df df_add(df x, df o) {
  const df se = two_sum(x.hi, o.hi);
  return quick_two_sum(se.hi, ad(se.lo, ad(x.lo, o.lo)));
}

__device__ __forceinline__ df df_sub(df x, df o) { return df_add(x, df_neg(o)); }

__device__ __forceinline__ df df_mul(df x, df o) {
  const df pe = two_prod(x.hi, o.hi);
  return quick_two_sum(pe.hi, ad(pe.lo, ad(ml(x.hi, o.lo), ml(x.lo, o.hi))));
}

__device__ __forceinline__ df df_div(df x, df o) {
  const float q1 = dv(x.hi, o.hi);
  const df r = df_sub(x, df_mul(o, df_f(q1)));
  const float q2 = dv(ad(r.hi, r.lo), o.hi);
  return quick_two_sum(q1, q2);
}

__device__ __forceinline__ df df_int_pow(df x, int n) {
  if (n == 0) return df{1.0f, 0.0f};
  if (n < 0) return df_div(df{1.0f, 0.0f}, df_int_pow(x, -n));
  df out = x;
  bool have = false;
  df base = x;
  while (n) {
    if (n & 1) {
      out = have ? df_mul(out, base) : base;
      have = true;
    }
    n >>= 1;
    if (n) base = df_mul(base, base);
  }
  return out;
}

// The constants (DF_LN2_HI, DF_EXP_TAIL, ...) are defined by the code
// generator (ops/cuda_rhs.py) as exact hexadecimal float literals of the
// values ops/df32.py uses, so both sides round nothing differently.

__device__ __forceinline__ df df_exp(df x) {
  const float k = rintf(ml(x.hi, DF_INV_LN2));  // round half to even
  const df r = df_sub(df_sub(x, df_f(ml(k, DF_LN2_HI))),
                      df{ml(k, DF_LN2_LO), ml(k, DF_LN2_LO2)});
  // Taylor tail Q(r) = sum_{k>=3} r^(k-3)/k!, plain f32 Horner
  const float tail_c[7] = DF_EXP_TAIL;
  float q = tail_c[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) q = ad(ml(q, r.hi), tail_c[i]);
  const df r2 = df_mul(r, r);
  const float tail = ml(ml(r2.hi, r.hi), q);
  df out = df_add(df_mul(r2, df_f(0.5f)), df_add(r, df_f(tail)));
  out = df_add(out, df_f(1.0f));
  const int ki = (int)k;
  return df{ldexpf(out.hi, ki), ldexpf(out.lo, ki)};
}

__device__ __forceinline__ df df_log(df x) {
  int ei;
  float m = frexpf(x.hi, &ei);  // x.hi = m * 2^e, m in [0.5, 1)
  const bool small = m < DF_SQRT_HALF;
  m = small ? ad(m, m) : m;
  const float e = (float)(ei - (small ? 1 : 0));
  const float num = sb(m, 1.0f);  // exact (Sterbenz)
  const df s = df_div(df_f(num), two_sum(m, 1.0f));
  const float s2 = ml(s.hi, s.hi);
  // atanh series 2/(2k+1), k = 5..1, plain f32 Horner
  const float tail_c[5] = DF_LOG_TAIL;
  float p = tail_c[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) p = ad(ml(p, s2), tail_c[i]);
  const float tail = ad(ml(ml(s2, s.hi), p), dv(x.lo, x.hi));
  df out = df{ad(s.hi, s.hi), ad(s.lo, s.lo)};
  out = df_add(out, df{ml(e, DF_LN2_HI), ml(e, DF_LN2_LO)});
  out = df_add(out, df_f(tail));
  if (x.hi < DF_TINY) {  // x <= 0 or denormal
    out.hi = __int_as_float(0x7fc00000);
    out.lo = out.hi;
  }
  return out;
}

__device__ __forceinline__ df df_log10(df x) {
  return df_mul(df_log(x), df{DF_INV_LN10_HI, DF_INV_LN10_LO});
}

__device__ __forceinline__ df df_sqrt(df x) {
  const float y0 = sqrtf(x.hi);
  const df r = df_sub(x, df_mul(df_f(y0), df_f(y0)));
  const float d = ad(r.hi, r.lo);
  return quick_two_sum(y0, dv(d, ad(y0, y0)));
}
