"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A share of a peak is stated against
these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12

FLOPS_PER_S = {
    "bf16": 989e12,      # tensor cores, bf16 and fp16
    "tf32": 495e12,      # tensor cores, TF32
    "f32": 67e12,        # CUDA cores, float32
}


def compute_kind(precision: str, part: str) -> str:
    """The peak a configuration's layer runs against: in 'fast' the frozen
    geometry encoder runs in bf16 and every other conv or matrix product in
    TF32; in 'strict' all of them run in float32 outside the tensor
    cores."""
    if precision == "strict":
        return "f32"
    return "bf16" if part == "encoder" else "tf32"
