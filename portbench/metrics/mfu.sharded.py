"""Per cent of the cards' float32 peak that the whole sharded epoch
uses: the operations one epoch needs on the whole graph, counted from
shapes (``counts.epoch_flops``), over its time in the measured window
(profiler off), against ``world`` × 67 TFLOP/s."""

from portbench import counts


def read(run):
    flops = counts.epoch_flops(run.shapes)
    return 100.0 * flops / run.step_s / (run.world * counts.PEAK_F32_FLOPS)
