// The port's dtype policy on the device, shared by every kernel source.
//
// * Complex<R>: complex64 (R = float) and complex128 (R = double), laid
//   out as torch stores them (real part, then imaginary part, aligned to
//   their size), with the arithmetic the kernels use.
// * Acc<T>: the type sums run in for values stored as T: float for the
//   half types, else T itself (repro_torch.core.spmv.storage_acc_dtype).
// * Promote<P, Q>: the result type of two operand types, as
//   torch.promote_types does for float64, float32, bfloat16 and float16,
//   for a complex type with a real type of its precision, and for
//   complex64 with complex128.
// * load_as<A>(v): a stored value converted to the sum type A (complex64
//   widened to complex128 exactly).
// * store_as<T>(v): a sum rounded once to the stored type T.
// * conj_of(v): the complex conjugate (the value itself for a real type).
// * mul_add(a, b, c): a * b + c, with fused multiply-adds; a real a times
//   a complex b is two of them, one a part.
// * make_scalar<T>(re, im): a coefficient handed over as two doubles.
//
// The Python side keeps the same rules (storage_acc_dtype, promote_types);
// a change here has to be made there too.  _build.py hashes this header
// into every library's name, so editing it rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename R> struct alignas(2 * sizeof(R)) Complex {
  R re, im;
  Complex() = default;  // trivial, so arrays of it may live in __shared__
  __host__ __device__ constexpr Complex(R r, R i = R(0)) : re(r), im(i) {}
};

template <typename R>
__device__ __forceinline__ Complex<R> operator+(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re + b.re, a.im + b.im);
}
template <typename R>
__device__ __forceinline__ Complex<R> operator-(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re - b.re, a.im - b.im);
}
template <typename R>
__device__ __forceinline__ Complex<R> operator-(Complex<R> a) {
  return Complex<R>(-a.re, -a.im);
}
template <typename R>
__device__ __forceinline__ Complex<R> operator*(Complex<R> a, Complex<R> b) {
  return Complex<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
template <typename R>
__device__ __forceinline__ Complex<R>& operator+=(Complex<R>& a, Complex<R> b) {
  return a = a + b;
}
template <typename R>
__device__ __forceinline__ Complex<R>& operator-=(Complex<R>& a, Complex<R> b) {
  return a = a - b;
}

template <typename T> __device__ __forceinline__ T conj_of(T v) { return v; }
template <typename R>
__device__ __forceinline__ Complex<R> conj_of(Complex<R> v) {
  return Complex<R>(v.re, -v.im);
}

template <typename T> __device__ __forceinline__ T mul_add(T a, T b, T c) {
  return a * b + c;
}
template <typename R>
__device__ __forceinline__ Complex<R> mul_add(Complex<R> a, Complex<R> b,
                                              Complex<R> c) {
  return Complex<R>(fma(a.re, b.re, fma(-a.im, b.im, c.re)),
                    fma(a.re, b.im, fma(a.im, b.re, c.im)));
}

// a real factor of a complex product: two fused multiply-adds, where the
// product with a zero imaginary part would take four
template <typename R>
__device__ __forceinline__ Complex<R> mul_add(R a, Complex<R> b,
                                              Complex<R> c) {
  return Complex<R>(fma(a, b.re, c.re), fma(a, b.im, c.im));
}

template <typename T> struct IsComplex { static constexpr bool value = false; };
template <typename R> struct IsComplex<Complex<R>> {
  static constexpr bool value = true;
};

template <typename T> __host__ __device__ inline T make_scalar(double re, double) {
  return (T)re;
}
template <> __host__ __device__ inline Complex<double> make_scalar(double re,
                                                                   double im) {
  return Complex<double>(re, im);
}
template <> __host__ __device__ inline Complex<float> make_scalar(double re,
                                                                  double im) {
  return Complex<float>((float)re, (float)im);
}

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };

template <typename P, typename Q> struct Promote { using type = float; };
template <typename P> struct Promote<P, P> { using type = P; };
template <typename Q> struct Promote<double, Q> { using type = double; };
template <typename P> struct Promote<P, double> { using type = double; };
template <> struct Promote<double, double> { using type = double; };
template <> struct Promote<Complex<double>, double> {
  using type = Complex<double>;
};
template <> struct Promote<Complex<float>, float> { using type = Complex<float>; };
template <> struct Promote<Complex<float>, Complex<double>> {
  using type = Complex<double>;
};

template <typename A> __device__ __forceinline__ A load_as(double v) { return (A)v; }
template <typename A> __device__ __forceinline__ A load_as(float v) { return (A)v; }
template <typename A> __device__ __forceinline__ A load_as(__nv_bfloat16 v) {
  return (A)__bfloat162float(v);
}
template <typename A> __device__ __forceinline__ A load_as(__half v) {
  return (A)__half2float(v);
}
template <typename A> __device__ __forceinline__ A load_as(Complex<double> v) {
  return v;
}
template <typename A> __device__ __forceinline__ A load_as(Complex<float> v) {
  return A(v.re, v.im);
}

template <typename T> __device__ __forceinline__ T store_as(double v) { return (T)v; }
template <typename T> __device__ __forceinline__ T store_as(float v) { return (T)v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half store_as(float v) {
  return __float2half(v);
}
template <typename T> __device__ __forceinline__ T store_as(Complex<double> v) {
  return v;
}
template <typename T> __device__ __forceinline__ T store_as(Complex<float> v) {
  return v;
}
