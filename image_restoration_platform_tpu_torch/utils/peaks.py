"""Published peak rates of the NVIDIA H100 SXM (80 GB HBM3), dense.

The denominators of every bound and utilization the port reports:
chip_smoke.py's kernel bounds and ``bench``'s model-FLOP utilization. They
are the card's data-sheet figures, not measurements: bf16 on the tensor
cores, f32 outside them, and the HBM3 bandwidth.
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
