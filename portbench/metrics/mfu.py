"""Per cent of the card's float32 peak that the whole step uses: the
operations one epoch (or request) needs, counted from shapes
(``counts.py``), over its time in the measured window (profiler off),
against 67 TFLOP/s (f32 outside the tensor cores; the port runs f32
with TF32 off)."""

from portbench import counts


def read(run):
    flops = (counts.request_flops(run.shapes) if run.kind == "serve"
             else counts.epoch_flops(run.shapes))
    return 100.0 * flops / run.step_s / counts.PEAK_F32_FLOPS
