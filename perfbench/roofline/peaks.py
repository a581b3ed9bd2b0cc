"""Published peaks by `torch.cuda.get_device_name()`: NVIDIA's data sheet
for the H100 SXM (HBM3 at 3.35 TB/s, at its 700 W limit), and the issue
ceiling of 132 SMs x 4 schedulers x 32 lanes at the 1.98 GHz boost
clock (thread instructions a second).  A card not listed has no
roofline."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"dram_bytes_per_s": 3.35e12,
                              "issue_ops_per_s": 132 * 128 * 1.98e9},
}


def peak_of(card: str) -> dict | None:
    return PEAKS.get(card)
