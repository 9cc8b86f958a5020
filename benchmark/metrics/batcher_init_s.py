"""The batcher's set-up (ContinuousBatcher.__init__): the program's
``setup`` span (the weights cast, quantized and placed on the device,
the KV cache made), in s."""

from benchmark import program_trace

UNIT = "s"


def read(rec):
    w = program_trace.window(rec)
    return None if w is None else w.setup.seconds
