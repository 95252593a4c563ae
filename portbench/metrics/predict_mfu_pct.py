"""The model step's share of the card's bf16 peak: the operations of the
UNet forwards of every frame (and each of its crops) completed in the
traced run's window before its first trace began, counted from the
configuration's shapes (``counts/unet.py``), over those seconds at 989
TFLOP/s."""

from portbench.counts.peaks import PEAK_BF16


def read(out, ctx):
    flops, seconds = out.record.get("untraced_flops"), out.record.get("untraced_s")
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16)
