"""Published peaks of one NVIDIA H100 SXM (NVIDIA H100 Tensor Core GPU
data sheet; dense rates at the full 700 W power limit): HBM3 bandwidth
and the rates outside the tensor cores, by data type.  A card set to a
lower power limit runs below them; the benchmark records the limit
beside every traced run."""

PEAK_BYTES = 3.35e12                                   # bytes/s
PEAK_OPS = {"float64": 34e12, "float32": 67e12}        # operations/s
