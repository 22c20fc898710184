// The port's dtype policy on the device, shared by every kernel source.
//
// * Acc<T>: the type sums run in for values stored as T: float for the
//   half types, else T itself (repro_torch.core.spmv.storage_acc_dtype).
// * Promote<P, Q>: the result type of two operand types, as
//   torch.promote_types does for float64, float32, bfloat16 and float16.
// * load_as<A>(v): a stored value converted to the sum type A.
// * store_as<T>(v): a sum rounded once to the stored type T.
//
// The Python side keeps the same rules (storage_acc_dtype, promote_types);
// a change here has to be made there too.  _build.py hashes this header
// into every library's name, so editing it rebuilds every kernel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };

template <typename P, typename Q> struct Promote { using type = float; };
template <typename P> struct Promote<P, P> { using type = P; };
template <typename Q> struct Promote<double, Q> { using type = double; };
template <typename P> struct Promote<P, double> { using type = double; };
template <> struct Promote<double, double> { using type = double; };

template <typename A> __device__ __forceinline__ A load_as(double v) { return (A)v; }
template <typename A> __device__ __forceinline__ A load_as(float v) { return (A)v; }
template <typename A> __device__ __forceinline__ A load_as(__nv_bfloat16 v) {
  return (A)__bfloat162float(v);
}
template <typename A> __device__ __forceinline__ A load_as(__half v) {
  return (A)__half2float(v);
}

template <typename T> __device__ __forceinline__ T store_as(double v) { return (T)v; }
template <typename T> __device__ __forceinline__ T store_as(float v) { return (T)v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half store_as(float v) {
  return __float2half(v);
}
