"""The decode loop (engine/generate.run_steps): the runtime's kernel
launches (cudaLaunchKernel and cudaLaunchKernelExC) in the traced span
over the loop steps in it, a loop step counted as one call of K2 (the
change of cp_decode_steps.launches over the span)."""

UNIT = "launches/step"


def read(rec):
    t = rec.get("trace")
    if not t or not t["counts"].get("K2"):
        return None
    return t["launches"] / t["counts"]["K2"]
