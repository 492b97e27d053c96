"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit). Both configurations state float32 with
TF32 off, so their work runs at the float32 rate outside the tensor
cores."""

F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
POWER_W = 700
