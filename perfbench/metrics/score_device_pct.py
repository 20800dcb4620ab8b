"""Share of an evaluation batch's device time in its scoring (PSNR and
SSIM): the device seconds (CUDA events on the stream) of the program's
span `srvp.eval.score` over those of `srvp.eval.batch`, in the traced
sub-window, in percent."""

from perfbench.program_spans import device_pct


def read(rec):
    return device_pct("srvp.eval.score", "srvp.eval.batch")
