"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its full 700 W power limit). A card set below that runs slower; the result
line records each card's power limit beside the shares."""
H100_SXM = {
    "fp32_flops": 67e12,  # float32 outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "hbm_bytes_s": 3.35e12,
    "hbm_bytes": 80e9,
}
