"""Set-up: from the start of the benchmark's process to the first
request of the window (imports, the CUDA context, weights from the seed,
quantization, the kernels' build where the checkout has none, warm-up)."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
