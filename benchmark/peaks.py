"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): the yardstick of every utilisation and roofline share."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,     # outside the tensor cores (TF32 off)
    "tfloat32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "float8": 1979e12,
}
