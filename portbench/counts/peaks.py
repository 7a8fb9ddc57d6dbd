"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). A share of a peak or of a
roofline is stated against these, with the card's name and power limit
beside it.

- ``BF16_FLOPS``: the bf16 tensor-core rate, the peak of the served cells,
  whose products take bf16 operands.
- ``F32_ACCURATE_FLOPS``: 495 TFLOP/s of TF32 split three ways (a float32
  operand as the sum of two TF32 parts needs three TF32 products for float32
  accuracy): the fastest float32-accurate rate of the card, the peak of the
  training cells, which compute in float32 with TF32 off. A change that keeps
  float32 accuracy can never read above 100 % of it.
- ``HBM_BYTES_PER_S``: the HBM3 rate.
"""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_ACCURATE_FLOPS = TF32_FLOPS / 3
F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
