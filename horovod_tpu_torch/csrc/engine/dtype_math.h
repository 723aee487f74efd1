// Elementwise reduction kernels over raw byte buffers, per DataType.
//
// Reference: the MPI backend leans on MPI_SUM/MIN/MAX with a custom AVX
// fp16 op (horovod/common/half.cc:42-78); here the kernels are our own,
// with bfloat16 first-class (the TPU's native half type) via round-to-
// nearest-even float conversion.
#pragma once

#include <cstddef>
#include <cstdint>

#include "common.h"

namespace hvdtpu {

// acc[i] op= in[i] for count elements of dtype t.
void ReduceInto(DataType t, ReduceOp op, void* acc, const void* in,
                size_t count);

// buf[i] *= factor (elementwise, in dtype).  Used for pre/postscale and
// Average's divide-by-size.
void ScaleInPlace(DataType t, void* buf, size_t count, double factor);

// Average's divide-by-size: integers floor-divide exactly (the Python
// engines' integer mean; a scale by 1/size would truncate toward zero),
// floating types scale by 1/size as ScaleInPlace does.
void AverageInPlace(DataType t, void* buf, size_t count, int size);

// dtype <-> double conversion for the Adasum path (dots accumulate in
// double, as the reference's DispatchComputeDotAndNormSqrds does).
void ToDouble(DataType t, const void* in, double* out, size_t count);
void FromDouble(DataType t, const double* in, void* out, size_t count);

// bfloat16/float16 scalar conversions (round-to-nearest-even on the way
// back down).
float Bf16ToF32(uint16_t v);
uint16_t F32ToBf16(float v);
float F16ToF32(uint16_t v);
uint16_t F32ToF16(float v);

}  // namespace hvdtpu
