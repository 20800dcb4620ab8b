"""Training frames (batch x frames of every step completed in the window)
over the window's time, host clock; the window closes on reading the last
step's loss."""


def read(rec):
    if rec.kind != "train" or not rec.window_s:
        return None
    return rec.frames / rec.window_s
