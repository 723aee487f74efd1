#include "dtype_math.h"

#include <algorithm>
#include <cmath>
#include <cstring>

namespace hvdtpu {

float Bf16ToF32(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t F32ToBf16(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  // Round to nearest even (the TPU's own bf16 rounding).
  uint32_t lsb = (bits >> 16) & 1;
  bits += 0x7FFF + lsb;
  return static_cast<uint16_t>(bits >> 16);
}

float F16ToF32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;
    } else {  // subnormal: normalize
      int shift = 0;
      while (!(mant & 0x400)) {
        mant <<= 1;
        shift++;
      }
      mant &= 0x3FF;
      bits = sign | ((127 - 15 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t F32ToF16(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFF;
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);  // inf/overflow
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t mid = 1u << (shift - 1);
    if (rem > mid || (rem == mid && (half & 1))) half++;
    return static_cast<uint16_t>(sign | half);
  }
  uint32_t half = (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFF;
  if (rem > 0x1000 || (rem == 0x1000 && (half & 1))) half++;
  return static_cast<uint16_t>(sign | half);
}

namespace {

template <typename T>
void ReduceTyped(ReduceOp op, T* acc, const T* in, size_t n) {
  switch (op) {
    case ReduceOp::MIN:
      for (size_t i = 0; i < n; i++) acc[i] = std::min(acc[i], in[i]);
      break;
    case ReduceOp::MAX:
      for (size_t i = 0; i < n; i++) acc[i] = std::max(acc[i], in[i]);
      break;
    default:  // SUM / AVERAGE (divide applied later) / ADASUM handled upstream
      for (size_t i = 0; i < n; i++) acc[i] += in[i];
      break;
  }
}

template <uint16_t (*ToBits)(float), float (*FromBits)(uint16_t)>
void ReduceHalf(ReduceOp op, uint16_t* acc, const uint16_t* in, size_t n) {
  for (size_t i = 0; i < n; i++) {
    float a = FromBits(acc[i]), b = FromBits(in[i]);
    float r;
    switch (op) {
      case ReduceOp::MIN: r = std::min(a, b); break;
      case ReduceOp::MAX: r = std::max(a, b); break;
      default: r = a + b; break;
    }
    acc[i] = ToBits(r);
  }
}

void ReduceBool(ReduceOp op, uint8_t* acc, const uint8_t* in, size_t n) {
  // Sum on bool = logical OR, min = AND, max = OR (MPI's C_BOOL behavior).
  switch (op) {
    case ReduceOp::MIN:
      for (size_t i = 0; i < n; i++) acc[i] = acc[i] && in[i];
      break;
    default:
      for (size_t i = 0; i < n; i++) acc[i] = acc[i] || in[i];
      break;
  }
}

}  // namespace

void ReduceInto(DataType t, ReduceOp op, void* acc, const void* in,
                size_t count) {
  switch (t) {
    case DataType::UINT8:
      ReduceTyped(op, static_cast<uint8_t*>(acc),
                  static_cast<const uint8_t*>(in), count);
      break;
    case DataType::INT8:
      ReduceTyped(op, static_cast<int8_t*>(acc),
                  static_cast<const int8_t*>(in), count);
      break;
    case DataType::INT32:
      ReduceTyped(op, static_cast<int32_t*>(acc),
                  static_cast<const int32_t*>(in), count);
      break;
    case DataType::INT64:
      ReduceTyped(op, static_cast<int64_t*>(acc),
                  static_cast<const int64_t*>(in), count);
      break;
    case DataType::FLOAT16:
      ReduceHalf<F32ToF16, F16ToF32>(op, static_cast<uint16_t*>(acc),
                                     static_cast<const uint16_t*>(in), count);
      break;
    case DataType::BFLOAT16:
      ReduceHalf<F32ToBf16, Bf16ToF32>(op, static_cast<uint16_t*>(acc),
                                       static_cast<const uint16_t*>(in), count);
      break;
    case DataType::FLOAT32:
      ReduceTyped(op, static_cast<float*>(acc),
                  static_cast<const float*>(in), count);
      break;
    case DataType::FLOAT64:
      ReduceTyped(op, static_cast<double*>(acc),
                  static_cast<const double*>(in), count);
      break;
    case DataType::BOOL:
      ReduceBool(op, static_cast<uint8_t*>(acc),
                 static_cast<const uint8_t*>(in), count);
      break;
  }
}

void ScaleInPlace(DataType t, void* buf, size_t count, double factor) {
  switch (t) {
    case DataType::UINT8: {
      auto* p = static_cast<uint8_t*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = static_cast<uint8_t>(p[i] * factor);
      break;
    }
    case DataType::INT8: {
      auto* p = static_cast<int8_t*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = static_cast<int8_t>(p[i] * factor);
      break;
    }
    case DataType::INT32: {
      auto* p = static_cast<int32_t*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = static_cast<int32_t>(p[i] * factor);
      break;
    }
    case DataType::INT64: {
      auto* p = static_cast<int64_t*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = static_cast<int64_t>(p[i] * factor);
      break;
    }
    case DataType::FLOAT16: {
      auto* p = static_cast<uint16_t*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = F32ToF16(static_cast<float>(F16ToF32(p[i]) * factor));
      break;
    }
    case DataType::BFLOAT16: {
      auto* p = static_cast<uint16_t*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = F32ToBf16(static_cast<float>(Bf16ToF32(p[i]) * factor));
      break;
    }
    case DataType::FLOAT32: {
      auto* p = static_cast<float*>(buf);
      for (size_t i = 0; i < count; i++)
        p[i] = static_cast<float>(p[i] * factor);
      break;
    }
    case DataType::FLOAT64: {
      auto* p = static_cast<double*>(buf);
      for (size_t i = 0; i < count; i++) p[i] *= factor;
      break;
    }
    case DataType::BOOL:
      break;  // scaling bools is meaningless; Average on bool stays OR
  }
}

namespace {

template <typename T>
void FloorDivide(void* buf, size_t count, int size) {
  auto* p = static_cast<T*>(buf);
  const T d = static_cast<T>(size);
  for (size_t i = 0; i < count; i++) {
    T q = static_cast<T>(p[i] / d);
    if ((p[i] % d != 0) && ((p[i] < 0) != (d < 0))) q--;
    p[i] = q;
  }
}

}  // namespace

void AverageInPlace(DataType t, void* buf, size_t count, int size) {
  switch (t) {
    case DataType::UINT8:
      FloorDivide<uint8_t>(buf, count, size);
      break;
    case DataType::INT8:
      FloorDivide<int8_t>(buf, count, size);
      break;
    case DataType::INT32:
      FloorDivide<int32_t>(buf, count, size);
      break;
    case DataType::INT64:
      FloorDivide<int64_t>(buf, count, size);
      break;
    default:
      ScaleInPlace(t, buf, count, 1.0 / size);
  }
}

void ToDouble(DataType t, const void* in, double* out, size_t count) {
  switch (t) {
    case DataType::UINT8: {
      auto* p = static_cast<const uint8_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = p[i];
      break;
    }
    case DataType::INT8: {
      auto* p = static_cast<const int8_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = p[i];
      break;
    }
    case DataType::INT32: {
      auto* p = static_cast<const int32_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = p[i];
      break;
    }
    case DataType::INT64: {
      auto* p = static_cast<const int64_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = static_cast<double>(p[i]);
      break;
    }
    case DataType::FLOAT16: {
      auto* p = static_cast<const uint16_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = F16ToF32(p[i]);
      break;
    }
    case DataType::BFLOAT16: {
      auto* p = static_cast<const uint16_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = Bf16ToF32(p[i]);
      break;
    }
    case DataType::FLOAT32: {
      auto* p = static_cast<const float*>(in);
      for (size_t i = 0; i < count; i++) out[i] = p[i];
      break;
    }
    case DataType::FLOAT64:
      std::memcpy(out, in, count * sizeof(double));
      break;
    case DataType::BOOL: {
      auto* p = static_cast<const uint8_t*>(in);
      for (size_t i = 0; i < count; i++) out[i] = p[i] ? 1.0 : 0.0;
      break;
    }
  }
}

void FromDouble(DataType t, const double* in, void* out, size_t count) {
  switch (t) {
    case DataType::UINT8: {
      auto* p = static_cast<uint8_t*>(out);
      for (size_t i = 0; i < count; i++) p[i] = static_cast<uint8_t>(in[i]);
      break;
    }
    case DataType::INT8: {
      auto* p = static_cast<int8_t*>(out);
      for (size_t i = 0; i < count; i++) p[i] = static_cast<int8_t>(in[i]);
      break;
    }
    case DataType::INT32: {
      auto* p = static_cast<int32_t*>(out);
      for (size_t i = 0; i < count; i++) p[i] = static_cast<int32_t>(in[i]);
      break;
    }
    case DataType::INT64: {
      auto* p = static_cast<int64_t*>(out);
      for (size_t i = 0; i < count; i++) p[i] = static_cast<int64_t>(in[i]);
      break;
    }
    case DataType::FLOAT16: {
      auto* p = static_cast<uint16_t*>(out);
      for (size_t i = 0; i < count; i++)
        p[i] = F32ToF16(static_cast<float>(in[i]));
      break;
    }
    case DataType::BFLOAT16: {
      auto* p = static_cast<uint16_t*>(out);
      for (size_t i = 0; i < count; i++)
        p[i] = F32ToBf16(static_cast<float>(in[i]));
      break;
    }
    case DataType::FLOAT32: {
      auto* p = static_cast<float*>(out);
      for (size_t i = 0; i < count; i++) p[i] = static_cast<float>(in[i]);
      break;
    }
    case DataType::FLOAT64:
      std::memcpy(out, in, count * sizeof(double));
      break;
    case DataType::BOOL: {
      auto* p = static_cast<uint8_t*>(out);
      for (size_t i = 0; i < count; i++) p[i] = in[i] != 0.0 ? 1 : 0;
      break;
    }
  }
}

}  // namespace hvdtpu
