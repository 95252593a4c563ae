"""The training step's share of the card's float32 peak: three times the
operations of the UNet forward (``counts/unet.py``, from the
configuration's shapes) for every sample of the steps that ended in the
traced run's window before its trace began, over those seconds at 67
TFLOP/s (float32 outside the tensor cores, since the configuration turns
TF32 off)."""

from portbench.counts.peaks import PEAK_F32


def read(out, ctx):
    flops, seconds = out.record.get("untraced_flops"), out.record.get("untraced_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_F32)
