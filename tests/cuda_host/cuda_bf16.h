// Host stand-ins for the bf16 types of the MRF kernel headers (see
// cuda_runtime.h here).
#pragma once
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
__nv_bfloat16 __float2bfloat16_rn(float);
float __bfloat162float(__nv_bfloat16);
float2 __bfloat1622float2(__nv_bfloat162);
__nv_bfloat162 __floats2bfloat162_rn(float, float);
