"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), at its 700 W limit.

HBM3 bandwidth 3.35 TB/s (NVIDIA's H100 data sheet). INT32 operations:
132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.73 TOP/s (NVIDIA Hopper
architecture white paper: 4 partitions of 16 INT32 units an SM). A share
of a roofline is stated against these, with the card's power limit
printed beside it.
"""

H100_SXM = {
    "name": "NVIDIA H100 80GB HBM3",
    "hbm_bytes_per_s": 3.35e12,
    "int32_ops_per_s": 132 * 64 * 1.98e9,
}
