"""The reference model's FLOPs for the cell's unit (a training step,
forward and backward; an evaluation batch; a serving call), times the
units of the window, over the window's time and the compute dtype's
peak (bf16 989e12, fp32 without TF32 67e12), in percent."""


def read(rec):
    if not (rec.flops_per_unit and rec.window_s and rec.peak_flops):
        return None
    return 100.0 * rec.flops_per_unit * rec.units / rec.window_s \
        / rec.peak_flops
